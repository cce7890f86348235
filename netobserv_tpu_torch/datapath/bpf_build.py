"""Build the eBPF datapath objects from the C sources in `datapath/bpf/`.

    python -m netobserv_tpu_torch.datapath.bpf_build

The port's form of the reference's CMake rules
(`netobserv_tpu/datapath/native/CMakeLists.txt:19-63`, option
DATAPATH_BPF): `flowpath.bpf.o` from `bpf/flowpath.c` with `clang -g -O2
-target bpf -D__TARGET_ARCH_<arch> -DNO_BPF_BUILD`, and, where `bpftool`
and `/sys/kernel/btf/vmlinux` exist, `flowpath_probes.bpf.o` from
`bpf/flowpath_probes.c` against a `vmlinux.h` dumped from the host's BTF.
The objects land in `bpf/build/` (gitignored), where
`datapath/loader._OBJ_PATH` looks for them. Nothing else compiles them:
the loader only loads an object that this build made, as the reference's
loads only one that CI built. Without clang the build raises, naming
clang (`CLANG` names another compiler).
"""

from __future__ import annotations

import os
import platform
import shutil
import subprocess
import sys

SRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bpf")
BUILD_DIR = os.path.join(SRC_DIR, "build")
OBJ_NAME = "flowpath.bpf.o"
PROBES_OBJ_NAME = "flowpath_probes.bpf.o"
VMLINUX_BTF = "/sys/kernel/btf/vmlinux"


def target_arch(machine: str | None = None) -> str:
    """The `__TARGET_ARCH_*` define of a machine name, as the CMake rules
    pick it from CMAKE_SYSTEM_PROCESSOR."""
    m = machine if machine is not None else platform.machine()
    if m in ("aarch64", "arm64"):
        return "__TARGET_ARCH_arm64"
    if m.startswith("ppc64"):
        return "__TARGET_ARCH_powerpc"
    if m.startswith("s390"):
        return "__TARGET_ARCH_s390"
    return "__TARGET_ARCH_x86"


def clang_path() -> str:
    want = os.environ.get("CLANG") or "clang"
    found = shutil.which(want)
    if found is None:
        raise RuntimeError(
            f"clang {want!r} not found (set CLANG): building the eBPF "
            "objects needs clang with the BPF target")
    return found


def _clang(clang: str, src: str, out: str, includes: list[str]) -> None:
    cmd = [clang, "-g", "-O2", "-target", "bpf", f"-D{target_arch()}",
           "-DNO_BPF_BUILD", "-c", src, "-o", out]
    cmd += [f"-I{d}" for d in includes]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")


def build(out_dir: str = BUILD_DIR) -> list[str]:
    """Compile the objects into `out_dir`; returns their paths (the probes
    object only where bpftool and the kernel's BTF exist)."""
    clang = clang_path()
    os.makedirs(out_dir, exist_ok=True)
    obj = os.path.join(out_dir, OBJ_NAME)
    _clang(clang, os.path.join(SRC_DIR, "flowpath.c"), obj, [SRC_DIR])
    built = [obj]
    bpftool = shutil.which("bpftool")
    if bpftool is None or not os.path.exists(VMLINUX_BTF):
        print("bpftool or /sys/kernel/btf/vmlinux missing: "
              f"{PROBES_OBJ_NAME} not built", file=sys.stderr)
        return built
    vmlinux_h = os.path.join(out_dir, "vmlinux.h")
    with open(vmlinux_h, "w") as fh:
        subprocess.run([bpftool, "btf", "dump", "file", VMLINUX_BTF,
                        "format", "c"], stdout=fh, check=True)
    probes = os.path.join(out_dir, PROBES_OBJ_NAME)
    _clang(clang, os.path.join(SRC_DIR, "flowpath_probes.c"), probes,
           [out_dir, SRC_DIR])
    built.append(probes)
    return built


def main() -> int:
    try:
        for path in build():
            print(path)
    except RuntimeError as exc:
        print(f"bpf_build: {exc}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
