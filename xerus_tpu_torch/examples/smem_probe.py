"""What a shared-memory load costs on the card: the probe behind K3's design.

    python3 -m xerus_tpu_torch.examples.smem_probe

Run from the root of a checkout on a machine with an NVIDIA card and
``nvcc``.  Compiles ``smem_probe.cu`` (beside this file; no kernel of any
path) into a temporary directory and prints cycles per warp-load from
shared memory on one SM, for 64- and 128-bit loads under four address
patterns: all lanes one address, 4 core slices in different banks, 4 slices
in the same banks, 32 consecutive addresses.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

PATTERNS = ["broadcast", "4 slices, different banks", "4 slices, same banks",
            "32 consecutive addresses"]
SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "smem_probe.cu")


def probe(dev, lib):
    import torch
    lib.xerus_smem_probe.argtypes = ([ctypes.c_int] * 5
                                     + [ctypes.c_void_p] * 3)
    lib.xerus_smem_probe.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cycles = torch.zeros((sms,), dtype=torch.int64, device=dev)
    sink = torch.zeros((1,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    iters, threads = 2048, 1024
    for width in (64, 128):
        for pattern, label in enumerate(PATTERNS):
            for _ in range(2):
                rc = lib.xerus_smem_probe(width, pattern, iters, threads, sms,
                                          cycles.data_ptr(), sink.data_ptr(),
                                          stream)
                if rc:
                    raise RuntimeError(f"probe launch failed: cudaError {rc}")
                torch.cuda.synchronize()
            per = cycles.double().median().item() / (iters * 16 * threads / 32)
            print(f"probe: {width}-bit shared loads, {label}: {per:.3f} "
                  f"cycles per warp-load on one SM ({threads} threads per "
                  f"SM, {iters * 16} loads per warp)")


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("smem_probe: needs an NVIDIA card")
    import xerus_tpu_torch
    from xerus_tpu_torch import build
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        lib_path = os.path.join(tmp, "libsmem_probe.so")
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", lib_path,
                        SOURCE], check=True, capture_output=True, text=True)
        probe(xerus_tpu_torch.cuda_device(), ctypes.CDLL(lib_path))


if __name__ == "__main__":
    main()
