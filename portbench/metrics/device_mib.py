"""The card memory the agent held at its peak over set-up and the measured
window (`torch.cuda.max_memory_allocated`), in MiB."""


def read(run):
    if run.memory_peak_bytes <= 0:
        return None
    return run.memory_peak_bytes / 2**20
