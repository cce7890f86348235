"""The port's traffic for tests and the card: `traffic` (the seeded
synthetic pools of `chip_smoke.py`), `synth` (deterministic pcaps) and the
scenario zoo, a copy of `netobserv_tpu/scenarios/`:

- `zoo.SCENARIOS` — name -> build(path) -> ground-truth dict
- `runner.run_scenario(name, workdir, device=)` — replay + grade one
  scenario through the port's agent
- `runner.evaluate(truth, observations)` — the grading logic alone
"""

from netobserv_tpu_torch.scenarios.zoo import SCENARIOS, SIGNALS  # noqa: F401
