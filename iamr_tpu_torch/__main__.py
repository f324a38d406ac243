"""Command line: `python -m iamr_tpu_torch <inputs-file> [key=value ...] [--device=DEV]`

The reference's executable convention (main.cpp): `./amr3d.ex inputs
max_step=3 ns.v=1`. The run goes to the card, cuda:0; it runs on the CPU
only when asked with --device=cpu, and without a CUDA device it exits
non-zero. ns.dtype sets the precision (default f32 on the card, f64 on
the CPU). On the card the last line counts the calls of each CUDA kernel's
wrapper in the run.
"""

import json
import sys

import torch

USAGE = "usage: python -m iamr_tpu_torch <inputs-file> [key=value ...] [--device=cpu|cuda[:N]]"


def main(argv) -> int:
    args = [a for a in argv if not a.startswith("--device=")]
    devices = [a.split("=", 1)[1] for a in argv if a.startswith("--device=")]
    if not args or any(a.startswith("-") for a in args):
        print(USAGE, file=sys.stderr)
        return 1
    device = torch.device(devices[-1] if devices else "cuda:0")
    if device.type == "cuda" and not torch.cuda.is_available():
        print("iamr_tpu_torch: no CUDA device; pass --device=cpu to run on the CPU",
              file=sys.stderr)
        return 2
    from iamr_tpu_torch.ns.driver import run_from_inputs
    from iamr_tpu_torch.ops import godunov_kernels, mg_kernels

    run_from_inputs(args[0], args[1:], device=device, verbose=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        print("kernel calls: " + json.dumps(dict(godunov_kernels.LAUNCHES, **mg_kernels.LAUNCHES)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
