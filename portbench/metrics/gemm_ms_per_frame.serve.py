"""gemm_ms_per_frame.serve: device ms a frame of the library GEMMs in the
render calls (the decoder's 64^2 layers and conv_a as torch.matmul)."""

from portbench.lib.readers import call_kernels, traced_frames


def read(run):
    frames = traced_frames(run)
    ks = call_kernels(run, "gemm")
    return sum(k[2] for k in ks) / 1e6 / frames if frames and ks else None
