"""Interactive web UI (streamlit) over the port's command line
(counterpart of cips3dpp_tpu/apps/web.py).

The reference wraps every inference workflow in Streamlit pages
(exp/cips3d/models/render_video_web_v10.py + tl2 run_web). Here each
workflow is a command of `python -m cips3dpp_torch.apps.cli`, and the UI is
a thin optional layer: it builds the command line of one form submission
(`build_argv`, the JAX package's argv for every mode), runs it, and shows
the videos, grids and JSON it wrote:

    streamlit run cips3dpp_torch/apps/web.py -- --cfg configs/ffhq.yaml

streamlit is not a dependency; without it `main()` prints how to reach the
same modes through the command line.
"""

from __future__ import annotations

import json
import os
import sys

# mode -> (cli command, [(arg-name, kind, default)]) where kind selects the
# streamlit widget: int / float / str(choices tuple) / flag / path
MODES = {
    "sample_multi_view": (
        "sample-multi-view",
        [
            ("view-mode", ("yaw", "circle", "translate_rotate"), None),
            ("n-frames", int, 16),
            ("truncation", float, 0.7),
            ("zero-noise", "flag", False),
            ("project-noise", "flag", False),
            ("fused", "flag", False),
        ],
    ),
    "fixed_zs_multi_view": (
        "fixed-zs-multi-view",
        [
            ("view-mode", ("circle", "elev_circle", "yaw"), None),
            ("n-zs", int, 4),
            ("n-frames", int, 16),
            ("truncation", float, 0.7),
        ],
    ),
    "interpolate_z": (
        "interpolate-z",
        [("n-frames", int, 16), ("truncation", float, 0.7)],
    ),
    "style_mixing": (
        "style-mixing",
        [("n-rows", int, 3), ("n-cols", int, 3)],
    ),
    "interpolate_decoder": (
        "interpolate-decoder",
        [("ckpt-b", "path", ""), ("n-frames", int, 1)],
    ),
    "invert": (
        "invert",
        [
            ("image", "path", ""),
            ("cam-param", ("angles", "axis_angle"), None),
        ],
    ),
    "render_inverted": (
        "render-inverted",
        [("inversion", "path", ""), ("n-frames", int, 16)],
    ),
    "lerp_inversions": (
        "lerp-inversions",
        [("inversions", "paths", ""), ("n-interp", int, 12)],
    ),
    "extract_shape": (
        "extract-shape",
        [("resolution", int, 128)],
    ),
}


def build_argv(mode: str, values: dict, cfg_path: str | None,
               section: str | None, outdir: str, seed: int) -> list[str]:
    """The command line (after `python -m cips3dpp_torch.apps.cli`) of one
    form submission; flags appear only when truthy."""
    cmd, spec = MODES[mode]
    argv = [cmd, "--outdir", outdir, "--seed", str(seed)]
    if cfg_path:
        argv += ["--cfg", cfg_path]
    if section:
        argv += ["--section", section]
    for name, kind, default in spec:
        v = values.get(name, default)
        if kind == "flag":
            if v:
                argv.append(f"--{name}")
        elif kind == "paths":
            if v:
                argv += [f"--{name}", *str(v).split()]
        elif v is not None and v != "":
            argv += [f"--{name}", str(v)]
    return argv


def main():
    try:
        import streamlit as st
    except ImportError:
        print(
            "streamlit is not installed; use the command line instead:\n"
            "  python -m cips3dpp_torch.apps.cli sample-multi-view ...\n"
            "(python -m cips3dpp_torch.apps.cli --help lists the commands; every "
            "mode here is one: " + ", ".join(cmd for cmd, _ in MODES.values()) + ")",
            file=sys.stderr,
        )
        return 1

    import argparse
    import tempfile

    from . import cli

    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg", type=str, default=None)
    parser.add_argument("--section", type=str, default=None)
    args = parser.parse_args()

    st.set_page_config(page_title="CIPS-3D++")
    st.title("CIPS-3D++")

    mode = st.sidebar.selectbox("mode", list(MODES), index=0)
    seed = int(st.sidebar.number_input("seed", value=0, step=1))

    values = {}
    for name, kind, default in MODES[mode][1]:
        if kind == "flag":
            values[name] = st.sidebar.checkbox(name, value=bool(default))
        elif kind is int:
            values[name] = int(st.sidebar.number_input(name, value=int(default), step=1))
        elif kind is float:
            values[name] = float(st.sidebar.number_input(name, value=float(default)))
        elif kind in ("path", "paths"):
            values[name] = st.sidebar.text_input(name, value=str(default))
        else:  # choices tuple
            values[name] = st.sidebar.selectbox(name, list(kind))

    if st.button("run"):
        outdir = tempfile.mkdtemp(prefix=f"web_{mode}_")
        argv = build_argv(mode, values, args.cfg, args.section, outdir, seed)
        st.code("python -m cips3dpp_torch.apps.cli " + " ".join(argv))
        with st.spinner("rendering..."):
            cli.main(argv)
        shown = False
        for fname in sorted(os.listdir(outdir)):
            fp = os.path.join(outdir, fname)
            if fname.endswith(".mp4"):
                st.video(fp)
                shown = True
            elif fname.endswith((".png", ".jpg")):
                st.image(fp)
                shown = True
            elif fname.endswith(".json"):
                with open(fp) as fh:
                    st.json(json.load(fh))
        if not shown:
            st.write(f"outputs in {outdir}: {os.listdir(outdir)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
