"""Time `chunk_accumulate` summing into a row of its own input, built
three ways from the port's `stream_reduce.cu`, on one CUDA card in one
process:

    python3 scripts/torch_accumulate_alias_ab.py --json build/alias_ab.json

The variants differ only in how the two accumulate kernels read: as
checked in, with ``__restrict__`` on ``x`` and ``out`` (``out`` is row 0
of ``x`` in the in-place call; the .cu says why the sum stays exact);
without the qualifiers; without them and with the vector loads through
``__ldg``. Each is built with the runtime's nvcc flags into
``build/alias_ab/`` (all three compilers started together), checked bit
for bit against ``x[0] + x[1]`` once, then timed in place at the chip
smoke's two train folds, (2, 310,378,496) and (2, 1,715,470,336) f32, with
CUDA events: ``--rounds`` rounds in the order checked in, no restrict,
ldg, ldg, no restrict, checked in, each reading 10 calls after 2 warm-up calls.
Prints one JSON object with every reading, the medians, the bytes bound
(each input read once, the output written once, at 3.35 TB/s) and the
card's name and power limit. Needs a CUDA card and nvcc; imports nothing
of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import runtime  # noqa: E402

SHAPES = ((2, 310_378_496), (2, 1_715_470_336))
HBM_BYTES_PER_S = 3.35e12
# the two accumulate kernels' parameter lines, as checked in
SIGNATURES = (
    "    const T* __restrict__ x, long long S, int n, long long n_vec, float* __restrict__ out) {",
    "    const T* __restrict__ x, long long S, int n, long long col0, float* __restrict__ out) {",
)


def variants(src: str) -> dict[str, str]:
    """The three sources; each substitution must apply."""
    plain = src
    for sig in SIGNATURES:
        if plain.count(sig) != 1:
            raise SystemExit("stream_reduce.cu's accumulate signatures have changed")
        plain = plain.replace(sig, sig.replace(" __restrict__", ""))
    ldg = plain.replace("*reinterpret_cast<const float4*>(p)",
                        "__ldg(reinterpret_cast<const float4*>(p))")
    ldg = ldg.replace("*reinterpret_cast<const uint4*>(p)",
                      "__ldg(reinterpret_cast<const uint4*>(p))")
    out = {"checked_in": src, "no_restrict": plain, "ldg": ldg}
    if len(set(out.values())) != 3:
        raise SystemExit("a variant's substitution did not apply to stream_reduce.cu")
    return out


def build(name: str, source: str, out_dir: Path) -> ctypes.CDLL:
    cu, so = out_dir / f"stream_reduce_{name}.cu", out_dir / f"libstream_reduce_{name}.so"
    cu.write_text(source)
    subprocess.run([runtime._nvcc(), *runtime.NVCC_FLAGS, "-o", str(so), str(cu)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.chunk_accumulate.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.chunk_accumulate.restype = ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--json", default=None, help="also write the result here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    out_dir = ROOT / "build" / "alias_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    srcs = variants((runtime.CSRC / "stream_reduce.cu").read_text())
    with ThreadPoolExecutor(len(srcs)) as ex:
        libs = dict(zip(srcs, ex.map(lambda kv: build(*kv, out_dir), srcs.items())))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    stream = torch.cuda.current_stream().cuda_stream
    result = {"nvidia_smi": smi, "cases": []}
    for n, s in SHAPES:
        x = torch.randn((n, s), device="cuda")
        want = x.sum(0)
        for name, lib in libs.items():
            y = x.clone()
            runtime.check(lib.chunk_accumulate(y.data_ptr(), s, n, 0, y.data_ptr(), stream), name)
            torch.cuda.synchronize()
            if not torch.equal(y[0], want):
                raise SystemExit(f"{name}: the in-place sum differs from x[0] + x[1]")
            del y
        ms = {k: [] for k in libs}
        order = ["checked_in", "no_restrict", "ldg", "ldg", "no_restrict",
                 "checked_in"] * args.rounds
        for name in order:
            call = libs[name].chunk_accumulate
            for _ in range(2):
                call(x.data_ptr(), s, n, 0, x.data_ptr(), stream)
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(10):
                call(x.data_ptr(), s, n, 0, x.data_ptr(), stream)
            t1.record()
            torch.cuda.synchronize()
            ms[name].append(t0.elapsed_time(t1) / 10)
        result["cases"].append({"shape": [n, s], "ms": ms,
                                "median_ms": {k: statistics.median(v) for k, v in ms.items()},
                                "bound_ms": (n + 1) * s * 4 / HBM_BYTES_PER_S * 1e3})
        del x, want
        torch.cuda.empty_cache()
    print(json.dumps(result))
    if args.json:
        Path(args.json).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
