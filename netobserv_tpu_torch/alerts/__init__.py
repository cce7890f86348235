"""The alerting plane: rules, the hysteresis engine and its sinks.

Counterpart of `netobserv_tpu/alerts/` (`rules.py`, `engine.py`,
`sinks.py`). Host-only: the engine evaluates the snapshots the exporter's
query plane publishes. With no rules (`config.QuerySettings.alert_rules`
empty) `engine.maybe_engine` returns None and the exporter has no engine.
"""
