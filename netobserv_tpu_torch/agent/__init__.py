"""Agent orchestration of the port: the flow agent (`agent.py`, a copy of
`netobserv_tpu/agent/agent.py`), the stage supervisor (`supervisor.py`, a
copy of `netobserv_tpu/agent/supervisor.py`) and the interface listener
(`interfaces_listener.py`, a copy of the reference's).
`python -m netobserv_tpu_torch` runs the agent."""

from netobserv_tpu_torch.agent.agent import (  # noqa: F401
    FlowsAgent, Status, build_fetcher, resolve_agent_ip,
)
from netobserv_tpu_torch.agent.supervisor import (  # noqa: F401
    StageState, Supervisor,
)
