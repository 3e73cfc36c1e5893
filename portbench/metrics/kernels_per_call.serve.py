"""kernels_per_call.serve: device kernels a render_frame call, over the
traced requests' calls (profiler)."""

from portbench.lib.readers import call_kernels, traced_calls


def read(run):
    calls, ks = traced_calls(run), call_kernels(run)
    return len(ks) / calls if calls and ks else None
