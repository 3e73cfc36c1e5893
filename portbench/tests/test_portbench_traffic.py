"""Traffic and inputs are a function of the seed: the same seed gives the
same requests, another seed the same sizes and angles with other
identities."""

from __future__ import annotations

import pytest
import torch

from portbench.lib import traffic as T
from portbench.lib.common import derive, load_named
from portbench.reference import serve as ref
from portbench.systems.serve import Inputs

from .portbench_small import small_config

SEEDS = (7, 2**31 + 5)


@pytest.mark.parametrize("mix_name", ["video36_f12"])
def test_video_plan(mix_name):
    mix = load_named("traffic", mix_name)
    plan = T.video_plan(mix)
    assert plan == T.video_plan(mix)
    assert len(plan) * mix["frames_per_call"] == mix["frames"]
    azim = [a for call, _ in plan for a in call]
    assert min(azim) >= mix["azim"][0] - 1e-12 and max(azim) <= mix["azim"][1] + 1e-12
    assert all(len(c) == mix["frames_per_call"] for c, _ in plan)


def test_seeds_derive_and_checks_are_stable():
    a, b = SEEDS
    assert T.request_seed(a, 3) == T.request_seed(a, 3) != T.request_seed(b, 3)
    assert derive(a, "x") != derive(a, "y")
    assert 0 <= derive(b, "weights") < 2**63
    mix = load_named("traffic", "video36_f12")
    picks = T.checked_requests(a, mix)
    assert picks == T.checked_requests(a, mix)
    assert len(picks) == mix["check_requests"] and max(picks) < mix["check_from"]


def test_request_inputs_follow_the_seed():
    cfg = small_config("ffhq_r1024_serve")
    g = ref.build(cfg["model"], torch.device("cpu"), lambda ms: None)
    shapes = g.decoder.noise_shapes(cfg["model"]["img_size"])
    draws = {}
    for s in SEEDS:
        inp = Inputs(cfg, s, torch.device("cpu"), shapes)
        draws[s] = [inp.request(i) for i in range(2)]
        again = Inputs(cfg, s, torch.device("cpu"), shapes).request(1)
        assert all(torch.equal(x, y) for x, y in zip(draws[s][1][0] + draws[s][1][1],
                                                      again[0] + again[1]))
    (za, na), (zb, nb) = draws[SEEDS[0]][0], draws[SEEDS[1]][0]
    assert [t.shape for t in za + na] == [t.shape for t in zb + nb]
    assert not torch.equal(za[0], zb[0])
    assert not torch.equal(draws[SEEDS[0]][0][0][0], draws[SEEDS[0]][1][0][0])


def test_weights_follow_the_seed():
    from portbench.lib.weights import draw_weights

    cfg = small_config("ffhq_r1024_serve")
    sds = []
    for s in (SEEDS[0], SEEDS[0], SEEDS[1]):
        g = ref.build(cfg["model"], torch.device("cpu"), lambda ms: None)
        draw_weights([g], s, torch.device("cpu"))
        sds.append(g.state_dict())
    assert all(torch.equal(sds[0][k], sds[1][k]) for k in sds[0])
    assert not all(torch.equal(sds[0][k], sds[2][k]) for k in sds[0])
    noise_w = [k for k in sds[0] if k.endswith("noise.weight")]
    assert noise_w and all(bool((sds[0][k] != 0).all()) for k in noise_w)
