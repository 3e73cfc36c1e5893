"""What every part of the harness shares: where things are, loading the
files a name points to, derived seeds, the no-JAX check and the result."""

from __future__ import annotations

import hashlib
import importlib.util
import json
import sys
import time
from pathlib import Path

PORTBENCH = Path(__file__).resolve().parent.parent
ROOT = PORTBENCH.parent
# top-level module names that must not be loaded where the port is measured
FORBIDDEN = ("jax", "jaxlib", "flax", "cips3dpp_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_named(kind: str, name: str, suffix: str = ".json"):
    """The file `portbench/<kind>/<name><suffix>`: parsed JSON, or for
    ".py" the module loaded from it. Raises FileNotFoundError naming the
    path where there is none."""
    path = PORTBENCH / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"{path.relative_to(ROOT)}: no such {kind} file")
    if suffix == ".json":
        return load_json(path)
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for one use of the run's seed: the same (seed, tags)
    give the same number, other tags give unrelated ones."""
    text = ":".join(str(t) for t in (seed, *tags)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def forbidden_modules(modules=None) -> list[str]:
    """The loaded modules whose top-level name (before the first dot) is a
    forbidden one, compared whole: `cips3dpp_torch` is not `cips3dpp_tpu`."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between order
    statistics (numpy's default rule)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


class Phases:
    """Set-up's phases on the host clock, each from the mark before
    (`sync` first, so device work lands in its phase), printed to
    standard error in one line by `report()`."""

    def __init__(self, t0: float, sync=lambda: None):
        self.t, self.sync, self.parts = t0, sync, []

    def mark(self, name: str) -> None:
        self.sync()
        now = time.perf_counter()
        self.parts.append((name, now - self.t))
        self.t = now

    def report(self) -> None:
        parts = ", ".join(f"{n} {s:.3f}" for n, s in self.parts)
        print(f"portbench: set-up phases (s): {parts}", file=sys.stderr)
