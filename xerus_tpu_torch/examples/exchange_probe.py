"""What an exchange between the CTAs of one cluster costs on the card: the
probe behind K2's float64 design.

    python3 -m xerus_tpu_torch.examples.exchange_probe

Run from the root of a checkout on a machine with an NVIDIA card and
``nvcc``.  Compiles ``exchange_probe.cu`` (beside this file; no kernel of
any path) into a temporary directory and prints, for one 16-CTA cluster,
the microseconds per repetition of a cluster barrier alone, of pushing
16-256 KB per CTA into the cluster's shared memory before it (as K2's
Newton-Schulz steps and slices do), and of the same bytes exchanged
through L2 instead (written, then read back by the other CTAs).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "exchange_probe.cu")
ITERS = 2000
# (mode, KB written or pushed per CTA, KB read per CTA)
CASES = [(0, 0, 0), (0, 16, 0), (0, 68, 0), (0, 136, 0), (0, 256, 0),
         (1, 68, 68), (1, 68, 136), (1, 16, 256)]


def probe(dev, lib):
    import torch
    lib.xerus_exchange_probe.argtypes = ([ctypes.c_int] * 4
                                         + [ctypes.c_void_p] * 3)
    lib.xerus_exchange_probe.restype = ctypes.c_int
    ws = torch.zeros((2 * 16 * 256 * 128,), dtype=torch.float64, device=dev)
    stale = torch.zeros((1,), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for mode, kb_out, kb_in in CASES:
        push, pull = kb_out * 128, kb_in * 128   # doubles
        times = []
        for iters in (10, ITERS):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            rc = lib.xerus_exchange_probe(mode, iters, push, pull,
                                          ws.data_ptr(), stale.data_ptr(),
                                          stream)
            end.record()
            if rc:
                raise RuntimeError(f"probe launch failed: cudaError {rc}")
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        us = times[1] * 1e3 / ITERS
        if mode == 0:
            what = (f"push {kb_out} KB per CTA into the cluster's shared "
                    f"memory + 1 cluster barrier")
        else:
            what = (f"write {kb_out} KB per CTA to global, read {kb_in} KB "
                    f"of the others' through L2 + 2 cluster barriers "
                    f"(stale reads {int(stale.item())})")
        print(f"exchange probe: {what}: {us:.3f} us per repetition "
              f"(16 CTAs x 256 threads, {ITERS} repetitions)")


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("exchange_probe: needs an NVIDIA card")
    import xerus_tpu_torch
    from xerus_tpu_torch import build
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        lib_path = os.path.join(tmp, "libexchange_probe.so")
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", lib_path,
                        SOURCE], check=True, capture_output=True, text=True)
        probe(xerus_tpu_torch.cuda_device(), ctypes.CDLL(lib_path))


if __name__ == "__main__":
    main()
