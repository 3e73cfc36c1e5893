"""mfu.serve: the whole serving step's share of the chip's peak, in %:
model FLOPs of a frame (work.flops, from the config's shapes) times the
frames of the traced requests, over the traced window's time and the
config's peak (bf16 dense)."""

from portbench.lib.readers import traced_frames
from portbench.work.flops import frame_flops


def read(run):
    frames = traced_frames(run)
    if not frames:
        return None
    flops = frame_flops(run.config["model"]) * frames
    return 100.0 * flops / (run.trace.window_s * run.config["peak_flops"])
