"""elementwise_ms_per_frame.serve: device ms a frame of the kernels in
the render calls that are neither K1, K2 nor a library GEMM: the eager
element-wise and reduction passes (camera, rays, glue)."""

from portbench.lib.readers import call_kernels, traced_frames


def read(run):
    frames = traced_frames(run)
    ks = call_kernels(run, "elementwise")
    return sum(k[2] for k in ks) / 1e6 / frames if frames and ks else None
