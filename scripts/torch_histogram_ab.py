"""Time the port's histogram kernel against the one of another tree of
this repository, on one CUDA card, in one process.

The other tree is typically an earlier commit unpacked where `.gitignore`
keeps it out of the repo:

    mkdir -p build/other && git archive <commit> | tar -x -C build/other
    python3 scripts/torch_histogram_ab.py --other build/other \\
        --json build/histogram_ab.json

Each tree's `histogram_kernel` is loaded with its own `kernels/runtime.py`,
so it builds its own `stream_reduce.cu` (under its own `build/`). The
inputs are the chip smoke's histogram cases (`chip_smoke.histogram_inputs`)
plus 2^24 uniform keys into 464,896 bins. Per case: both outputs against
the plain version (bit for bit at counts of 1, else 1e-5 of the largest
bin), then ``--rounds`` rounds of profiler device ms (the output's zero
fill and the kernel), each round timing other, this, this, other. The
verdict compares the spreads: "faster" when this tree's slowest reading
is under the other's fastest, "slower" in the mirror case, else
"unresolved". Prints one JSON line per case and the card's name and power
limit. Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import importlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def wrapper_of(src: Path):
    """`histogram_kernel` of the `repro_torch` package under ``src``,
    imported apart from the one this process already holds (each keeps its
    own runtime, so each builds and loads its own kernel source)."""
    def ours(name: str) -> bool:
        return name == "repro_torch" or name.startswith("repro_torch.")

    held = {k: sys.modules.pop(k) for k in [k for k in sys.modules if ours(k)]}
    sys.path.insert(0, str(src))
    try:
        mod = importlib.import_module("repro_torch.kernels.stream_reduce.stream_reduce")
    finally:
        sys.path.remove(str(src))
        for k in [k for k in sys.modules if ours(k)]:
            del sys.modules[k]
        sys.modules.update(held)
    return mod.histogram_kernel


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, required=True, help="root of the other tree")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", type=Path, default=None, help="also write the lines here")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels.stream_reduce import histogram_kernel, keyed_histogram
    from repro_torch.kernels.stream_reduce.stream_reduce import CTA_BINS

    other = wrapper_of(args.other.resolve() / "src")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    lines = [{"card": card.strip().splitlines()[0] if card.strip() else "not read",
              "other": str(args.other), "rounds": args.rounds}]
    print(json.dumps(lines[0]), flush=True)
    edges = (CTA_BINS, CTA_BINS + 1, 464_896)
    for name, keys, counts, bins, exact, iters in cs.histogram_inputs(torch, np, args.seed,
                                                                        edges=edges):
        ref = keyed_histogram(keys, counts, bins, impl="ref")
        top = ref.max().item()
        for which, fn in (("this", histogram_kernel), ("other", other)):
            got = fn(keys, counts, bins)
            err = (got - ref).abs().max().item()
            if not (torch.equal(got, ref) if exact else err / top <= cs.HIST_REL):
                raise AssertionError(f"{which} tree's kernel disagrees at {name}: {err}")
        runs = {"this": [], "other": []}
        for _ in range(args.rounds):
            for which in ("other", "this", "this", "other"):
                fn = histogram_kernel if which == "this" else other
                runs[which].append(cs.device_ms(torch, [lambda f=fn: f(keys, counts, bins)],
                                                iters))
        this, them = runs["this"], runs["other"]
        verdict = ("faster" if max(this) < min(them) else
                   "slower" if min(this) > max(them) else "unresolved")
        line = {"case": name, "bins": bins, "n": keys.shape[0],
                "this_median_ms": statistics.median(this),
                "other_median_ms": statistics.median(them),
                "this_ms": this, "other_ms": them, "verdict": verdict}
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text("\n".join(json.dumps(x) for x in lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
