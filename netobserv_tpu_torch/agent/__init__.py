"""Agent orchestration of the port: so far the stage supervisor
(`supervisor.py`, a copy of `netobserv_tpu/agent/supervisor.py`). The
agent entry comes with ROADMAP A4.6."""

from netobserv_tpu_torch.agent.supervisor import (  # noqa: F401
    StageState, Supervisor,
)
