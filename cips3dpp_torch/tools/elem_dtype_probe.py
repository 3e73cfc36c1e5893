"""Does the card run bf16 elementwise arithmetic faster than f32?

    python -m cips3dpp_torch.tools.elem_dtype_probe [--device cuda] [--iters 40]

The counterpart of the TPU probe tools/vpu_dtype_probe.py: the decoder
block's post-matmul chain, 12 times x = lrelu(x + s*n + b) (max form,
lrelu(v) = max(v, 0.2 v) * sqrt2), over one (1024, 16, 128) array, once in
f32 and once in bf16, through the CUDA kernel `csrc/elem_probe.cu` (P1).
Each dtype is checked bit for bit against `elem_chain_plain` on the same
inputs and timed by the profiler's device time a launch, rotating 8
input/output sets (3 x 8 x 8 MB in f32) so that the timed launches read
device memory, not the 50 MB L2. Prints one JSON line per dtype and one
with the bf16/f32 ratio of elements per second (elements x 12 chained
passes, as the TPU probe counts them).
"""

from __future__ import annotations

import argparse
import ctypes
import json

import torch

from ..kernels import _lib

SHAPE = (1024, 16, 128)
REPS = 12
ROTATE = 8
# constants of the chain, rounded to the working dtype before use
CONSTS = {"s": 0.31, "b": 0.013, "slope": 0.2, "sqrt2": 1.4142135623730951}


def elem_chain_plain(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: every product and sum rounded
    to x's dtype on its own, in the order (x + s*n) + b."""
    c = {k: torch.tensor(v, dtype=x.dtype, device=x.device) for k, v in CONSTS.items()}
    for _ in range(REPS):
        v = (x + c["s"] * n) + c["b"]
        x = torch.maximum(v, c["slope"] * v) * c["sqrt2"]
    return x


def _launch(x, n, out):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"elem_probe kernel: dtype {x.dtype}, want f32 or bf16")
    count = x.numel()
    if count % 8:
        raise ValueError(f"elem_probe kernel: {count} elements, want a multiple of 8")
    for t, name in ((x, "x"), (n, "n"), (out, "out")):
        _lib.check(t, name, x.shape, x.dtype, x.device)
    lib = _lib.load("elem_probe")
    fn = lib.elem_probe_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    bf16 = x.dtype == torch.bfloat16
    code = fn(_lib.ptr(x), _lib.ptr(n), _lib.ptr(out), count, int(bf16),
              _lib.stream_ptr(x.device))
    _lib.raise_on_error(code, "elem_probe")
    _lib.LAUNCHES["elem_probe_bf16" if bf16 else "elem_probe_f32"] += 1
    return out


def elem_chain(x: torch.Tensor, n: torch.Tensor, out: torch.Tensor | None = None):
    """The chain through the CUDA kernel for tensors on the card, through
    `elem_chain_plain` for tensors on the CPU."""
    if x.device.type == "cuda":
        out = torch.empty_like(x) if out is None else out
        return _launch(x.contiguous(), n.contiguous(), out)
    if x.device.type == "cpu":
        return elem_chain_plain(x, n)
    raise ValueError(f"elem_probe: no kernel for device {x.device}")


def _events_ms(fn, iters):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn(0)
    torch.cuda.synchronize()
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@torch.no_grad()
def measure(dtype: str, device=None, iters: int = 40, seed: int = 0) -> dict:
    """Check and time the kernel in one dtype ("float32" or "bfloat16") on
    the card: {"max_abs_err", "bit_equal", "ms" (device time a launch,
    profiler), "issue_ms" (CUDA events over back-to-back calls, the host's
    issue rate included), "plain_ms", "elems_per_s" (from "ms"),
    "elements", "bytes"}."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("elem_dtype_probe measures the card: no CUDA device")
    dt = DTYPES[dtype]
    gen = torch.Generator().manual_seed(seed)
    xs = [torch.randn(SHAPE, generator=gen).to(dev, dt) for _ in range(ROTATE)]
    ns = [torch.randn(SHAPE, generator=gen).to(dev, dt) for _ in range(ROTATE)]
    outs = [torch.empty_like(xs[0]) for _ in range(ROTATE)]
    got = elem_chain(xs[0], ns[0], outs[0])
    want = elem_chain_plain(xs[0], ns[0])
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())

    def run(i):
        elem_chain(xs[i % ROTATE], ns[i % ROTATE], outs[i % ROTATE])

    issue_ms = _events_ms(run, iters)
    ms = _lib.device_ms(run, iters, "probe_bf16" if dt == torch.bfloat16 else "probe_f32")
    plain_ms = _events_ms(lambda i: elem_chain_plain(xs[i % ROTATE], ns[i % ROTATE]),
                          max(2, iters // 8))
    count = xs[0].numel()
    return {"max_abs_err": err, "bit_equal": bool(torch.equal(got, want)),
            "ms": ms, "issue_ms": issue_ms, "plain_ms": plain_ms,
            "elems_per_s": count * REPS / (ms * 1e-3), "elements": count,
            "bytes": 3 * count * xs[0].element_size()}


def probe(device=None, iters: int = 40, seed: int = 0) -> dict:
    """`measure` in f32 and bf16, and "bf16_over_f32", the ratio of their
    elements per second."""
    out = {name: measure(name, device, iters, seed) for name in DTYPES}
    out["bf16_over_f32"] = out["bfloat16"]["elems_per_s"] / out["float32"]["elems_per_s"]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default=None, help="a CUDA device (default: cuda)")
    p.add_argument("--iters", type=int, default=40)
    args = p.parse_args(argv)
    res = probe(args.device, args.iters)
    for name in ("float32", "bfloat16"):
        r = res[name]
        print(json.dumps({"dtype": name, **r}))
        if not r["bit_equal"]:
            raise SystemExit(f"{name}: kernel and plain chain differ by {r['max_abs_err']}")
    print(json.dumps({"bf16_over_f32": res["bf16_over_f32"],
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
