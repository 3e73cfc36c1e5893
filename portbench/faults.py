"""Faults planted in the program's timed path, for the checks that
`correct` comes out false (tests/test_portbench_correct.py) and for the
readings of a fault on the chip (calibrate.py). Each wraps a function of
the program and is installed by `plant(name)`, which returns an undo."""

from __future__ import annotations


def altered_frame(original):
    """A served answer altered where it is made: the last frame of every
    render call shifted by 0.25."""
    def render_frame(*a, **k):
        out = original(*a, **k)
        out["rgb"] = out["rgb"].clone()
        out["rgb"][-1] += 0.25
        return out
    return render_frame


def half_the_frames(original):
    """Half of a call's frames left out: the first half rendered, repeated
    in the places of the rest."""
    def render_frame(model, prep, azim, elev, **k):
        half = max(1, azim.shape[0] // 2)
        out = original(model, prep, azim[:half], elev[:half], **k)
        rep = -(-azim.shape[0] // half)
        return {key: v.repeat(rep, *[1] * (v.ndim - 1))[:azim.shape[0]]
                for key, v in out.items()}
    return render_frame


def unchanged_state(make):
    """A D step that returns its state unchanged: both discriminators'
    optimizer steps skipped."""
    def make_train_steps(*a, **k):
        d_step, g_step, path_step, sphere = make(*a, **k)

        def d_step_unchanged(state, *args, **kw):
            keep = (state.opt_d.step, state.opt_d_render.step)
            state.opt_d.step = state.opt_d_render.step = lambda grads: None
            try:
                return d_step(state, *args, **kw)
            finally:
                state.opt_d.step, state.opt_d_render.step = keep
        return d_step_unchanged, g_step, path_step, sphere
    return make_train_steps


def half_the_batch(make):
    """Half of the batch left out of the D step, its means over the rest."""
    def make_train_steps(*a, **k):
        d_step, g_step, path_step, sphere = make(*a, **k)

        def d_step_half(state, real, *args, **kw):
            return d_step(state, real[: max(1, real.shape[0] // 2)], *args, **kw)
        return d_step_half, g_step, path_step, sphere
    return make_train_steps


def _targets():
    from cips3dpp_torch import serving
    from cips3dpp_torch.train import train_loop

    return {"altered_frame": (serving, "render_frame", altered_frame),
            "half_the_frames": (serving, "render_frame", half_the_frames),
            "unchanged_state": (train_loop, "make_train_steps", unchanged_state),
            "half_the_batch": (train_loop, "make_train_steps", half_the_batch)}


FAULTS = ("altered_frame", "half_the_frames", "unchanged_state", "half_the_batch")


def plant(name: str):
    module, attr, wrap = _targets()[name]
    original = getattr(module, attr)
    setattr(module, attr, wrap(original))
    return lambda: setattr(module, attr, original)
