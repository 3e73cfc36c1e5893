"""mfu.train: the whole training step's share of the chip's peak, in %:
the model FLOPs of each traced iteration (work.flops, counted on the
reference at the config's shapes, for the iteration's kind: lazy R1, path
regularisation or neither) over the traced window's time and the config's
peak (f32 outside the tensor cores: TF32 is off)."""

from portbench.lib.readers import traced_units
from portbench.work.flops import iteration_flops


def read(run):
    units = traced_units(run)
    if not units:
        return None
    tcfg = run.config["train"]
    flops = 0
    for u in units:
        i = u["idx"] + 1
        flops += iteration_flops(run.config, i % tcfg["d_reg_every"] == 0,
                                 i % tcfg["g_reg_every"] == 0)
    return 100.0 * flops / (run.trace.window_s * run.config["peak_flops"])
