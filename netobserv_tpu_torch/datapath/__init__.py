"""The datapath: the kernel's BPF programs and their bpf(2) layer, the
fetchers that drain their maps, the replay fetchers and the host-side
packers of the flow feeds."""
