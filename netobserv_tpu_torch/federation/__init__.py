"""The port's federation plane: the delta frame codec (`delta.py` on
`pbwire.py`), the in-place table merge (`statemerge.py`), the
single-device aggregator (`aggregator.py`) and its query surface
(`query.py`)."""
