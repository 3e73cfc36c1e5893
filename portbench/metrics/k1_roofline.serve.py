"""k1_roofline.serve: K1's share of its roofline, in %: the least time of
its work at the call's shapes (frames x img^2 rays, the config's samples
and width; the frozen `k1_work` / `bound`) over the profiler's mean device
time a K1 launch in the render calls."""

from portbench.lib.readers import call_kernels
from portbench.work.roofline import k1_bound_ms


def read(run):
    ks = call_kernels(run, "k1")
    if not ks:
        return None
    m = run.config["model"]
    rays = run.frames_per_call * m["img_size"] ** 2
    kernel_ms = sum(k[2] for k in ks) / 1e6 / len(ks)
    return 100.0 * k1_bound_ms(rays, m["n_samples"], m["renderer"]["hidden_dim"]) / kernel_ms
