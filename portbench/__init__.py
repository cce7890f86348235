"""The benchmark of the PyTorch and CUDA port (`netobserv_tpu_torch`).

`BENCHMARK.json` at the root of the repository names its cells; each is
one node-agent configuration (`configs/<name>.json`) under one traffic mix
(`traffic/<name>.json`), run by `python -m portbench.run` (`run.py`,
`harness.py`) and judged against the plain reference (`reference/`). A
metric is read by `metrics/<name>.py`, a cell's limits and warm-up are
`cells/<cell>.json`: a later cell, mix or metric is files and entries
added, with no file here edited. Nothing here imports JAX or the JAX
package.
"""
