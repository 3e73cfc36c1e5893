"""The one generator of every traffic mix: a mix is a JSON file of
parameters under `portbench/traffic/`, and its "kind" says which of the
plans below reads it. The same seed gives the same requests; another seed
gives the same sizes and angles with other identities, so every seed
does the same work."""

from __future__ import annotations

import math
import random

from .common import derive


def video_plan(mix: dict):
    """The camera angles of one request of a "video" mix, one (azim, elev)
    list pair a render call: `frames` views on the multi-view app's
    sinusoidal yaw path from azim[0] to azim[1] and back (t in [0, 1],
    azim0 + (azim1 - azim0) sin(pi t)) at `elev`, `frames_per_call` a
    call."""
    n, f = mix["frames"], mix["frames_per_call"]
    if n % f:
        raise ValueError(f"{n} frames do not split into calls of {f}")
    a0, a1 = mix["azim"]
    azim = [a0 + (a1 - a0) * math.sin(math.pi * i / max(1, n - 1)) for i in range(n)]
    elev = [float(mix["elev"])] * n
    return [(azim[i:i + f], elev[i:i + f]) for i in range(0, n, f)]


def request_seed(seed: int, index: int) -> int:
    """The seed of request `index` of a run (negative indices: warm-up)."""
    return derive(seed, "request", index)


def checked_requests(seed: int, mix: dict) -> list[int]:
    """The requests whose outputs are compared: `check_requests` of the
    first `check_from` (every run completes those), drawn from the seed."""
    rng = random.Random(derive(seed, "check"))
    return sorted(rng.sample(range(mix["check_from"]), mix["check_requests"]))
