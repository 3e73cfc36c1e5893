"""k2_roofline.serve: K2's share of its roofline, in %: the least time of
a call's upsample blocks (the frozen `decoder_block_work` / `bound` at each
block's y1 and C, feat stored but by the last, ToRGB folded, noise from
buffers, the decoder's storage dtype) over the profiler's device time of
the K2 launches a call."""

from portbench.lib.readers import call_kernels, traced_calls
from portbench.reference.plain.models.layers import channel_table
from portbench.work.roofline import decoder_block_bound_ms


def read(run):
    ks = call_kernels(run, "k2")
    calls = traced_calls(run)
    if not ks or not calls:
        return None
    d = run.config["model"]["decoder"]
    es = 2 if d["dtype"] == "bfloat16" else 4
    table = channel_table(d["channel_multiplier"])
    side = run.config["model"]["img_size"]
    ups = sorted(d["upsample_list"])
    bound = 0.0
    for i, size in enumerate(ups):
        bound += decoder_block_bound_ms(side, side, table[size], es, hashed=False,
                                        emit_feat=i + 1 < len(ups),
                                        frames=run.frames_per_call)
        side *= 2
    kernel_ms = sum(k[2] for k in ks) / 1e6 / calls
    return 100.0 * bound / kernel_ms
