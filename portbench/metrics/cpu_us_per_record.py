"""The process's CPU time, user and system, every thread, over the
measured window, in microseconds per record folded: the agent's cost on
its node. The traffic is made in set-up, so the generator thread adds
only its loop."""


def read(run):
    if run.records <= 0:
        return None
    return run.cpu_s / run.records * 1e6
