"""Weight bridge: the JAX package's param trees (generator, image D,
pose D, multi-scale D, triplane renderer, VGG16, LPIPS and the FID
Inception) and artifacts (a TrainState, an inversion's
w.pkl) -> this package's state dicts.

The input is the nested dict of `variables["params"]` of the flax
Generator, as numpy arrays (or anything `np.asarray` takes). The output
uses the reference's torch state-dict names and layouts, which are this
package's module names, so `Generator.load_state_dict` takes it as is:

    flax Linear        (in, out)        -> (out, in)
    flax modulated conv (k, k, in, out) -> (1, out, in, k, k), any k

    flax conv          (kh, kw, in, out) -> (out, in, kh, kw)

The mappings are this package's own copies of the JAX package's exporters
(`io/torch_import.py:export_generator_state_dict`,
`export_d_stylegan_state_dict`, `export_d_pose_state_dict`); they import
nothing of JAX. Each is a permutation of the values (plus the zero
StyledConv.bias the reference carries), so it carries Adam's moments as
it carries the weights: `load_jax_train_state` turns a whole JAX
TrainState (weights, EMA, optax states, counters) into the port's.
"""

from __future__ import annotations

import pickle
from typing import Mapping

import numpy as np
import torch


def jax_params_to_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """State dict of the whole generator tree, or of the parts present
    (a tree holding only "renderer" or "decoder" gives those keys)."""
    out: dict[str, np.ndarray] = {}

    def linear(w):
        return np.ascontiguousarray(np.asarray(w, np.float32).T)

    def modconv(w):
        w = np.asarray(w, np.float32)  # (k, k, in, out)
        return np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))[None]

    def put_linear(prefix, node):
        out[f"{prefix}.weight"] = linear(node["weight"])
        out[f"{prefix}.bias"] = np.asarray(node["bias"], np.float32)

    def put_film(prefix, node):
        put_linear(prefix, node)
        put_linear(f"{prefix}.gamma", node["gamma"])
        put_linear(f"{prefix}.beta", node["beta"])

    def put_modconv(prefix, node):
        out[f"{prefix}.weight"] = modconv(node["weight"])
        put_linear(f"{prefix}.modulation", node["modulation"])

    def put_styled(prefix, node):
        put_modconv(f"{prefix}.conv", node["conv"])
        out[f"{prefix}.noise.weight"] = np.asarray(node["noise"]["weight"], np.float32)
        bias = np.asarray(node["act_bias"], np.float32)
        out[f"{prefix}.activate.bias"] = bias
        # the reference's unused StyledConv.bias
        out[f"{prefix}.bias"] = np.zeros((1, bias.shape[0], 1, 1), np.float32)

    def put_torgb(prefix, node):
        put_modconv(f"{prefix}.conv", node["conv"])
        out[f"{prefix}.bias"] = np.asarray(node["bias"], np.float32).reshape(1, -1, 1, 1)

    i = 0
    while f"style_{i}" in params:
        put_linear(f"style.{i}", params[f"style_{i}"])
        i += 1
    i = 0
    while f"style_decoder_{i}" in params:
        # index 0 of the reference Sequential is PixelNorm
        put_linear(f"style_decoder.{i + 1}", params[f"style_decoder_{i}"])
        i += 1

    if "renderer" in params:
        rend = params["renderer"]
        out["renderer.sigmoid_beta"] = np.asarray(rend["sigmoid_beta"], np.float32)
        net = rend["network"]
        i = 0
        while f"pts_{i}" in net:
            put_film(f"renderer.network.pts_linears.{i}", net[f"pts_{i}"])
            i += 1
        put_film("renderer.network.views_linears", net["views"])
        put_linear("renderer.network.rgb_linear", net["rgb_head"])
        put_linear("renderer.network.sigma_linear", net["sigma_head"])

    if "decoder" in params:
        dec = params["decoder"]
        put_styled("decoder.conv1", dec["conv1"])
        put_torgb("decoder.to_rgb1", dec["to_rgb1"])
        i = 0
        while f"convs_{i}" in dec:
            put_styled(f"decoder.convs.{i}", dec[f"convs_{i}"])
            i += 1
        i = 0
        while f"to_rgbs_{i}" in dec:
            put_torgb(f"decoder.to_rgbs.{i}", dec[f"to_rgbs_{i}"])
            i += 1
    return _tensors(out)


def _conv(w):
    return np.ascontiguousarray(np.transpose(np.asarray(w, np.float32), (3, 2, 0, 1)))


def _vec(v):
    return np.asarray(v, np.float32)


def _tensors(out):
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def _indexed(name: str, stem: str) -> str:
    """flax "conv_in_64" -> "conv_in.64"; the flat Ds' "conv_in" stays."""
    return stem + name[len(stem):].replace("_", ".", 1)


def _conv_layer(out, prefix, node, conv_index):
    """A flax ConvLayer -> the port's ConvLayer (a Sequential: the
    EqualConv2d at `conv_index`, behind a Blur when it downsamples)."""
    out[f"{prefix}.{conv_index}.weight"] = _conv(node["EqualConv2d_0"]["weight"])
    if "act_bias" in node:
        out[f"{prefix}.{conv_index + 1}.bias"] = _vec(node["act_bias"])


def _d_trunk(out, params):
    """The image Ds' per-resolution input convs and ResBlocks."""
    for name, node in params.items():
        if name.startswith("conv_in"):
            _conv_layer(out, _indexed(name, "conv_in"), node, 0)
        elif name.startswith("block_"):
            res = name[len("block_"):]
            _conv_layer(out, f"blocks.{res}.conv1", node["conv1"], 0)
            _conv_layer(out, f"blocks.{res}.conv2", node["conv2"], 1)
            _conv_layer(out, f"blocks.{res}.skip", node["skip"], 1)


def _linear(out, prefix, node, hwc=False):
    """A flax EqualLinear -> (out, in); with `hwc` its input is a 4x4 map
    that flax flattens channel-last (h, w, c) and torch as (c, h, w)."""
    w = np.asarray(node["weight"], np.float32)
    if hwc:
        c = w.shape[0] // 16
        w = w.reshape(4, 4, c, -1).transpose(2, 0, 1, 3).reshape(16 * c, -1)
    out[f"{prefix}.weight"] = np.ascontiguousarray(w.T)
    out[f"{prefix}.bias"] = _vec(node["bias"])


def jax_d_params_to_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """DStyleGANProgressive (or DStyleGAN) params -> `models/discriminator.py`
    names."""
    out = {}
    _d_trunk(out, params)
    final = params["final"]
    _conv_layer(out, "final_conv", final["final_conv"], 0)
    _linear(out, "final_linear.0", final["final_linear_0"], hwc=True)
    _linear(out, "final_linear.1", final["final_linear_1"])
    return _tensors(out)


def jax_ms_d_params_to_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """DiscriminatorMultiScale params -> `models/discriminator_multi_scale.py`
    names (the JAX tree's, with the image D's ConvLayer internals)."""
    out = {}
    _d_trunk(out, params)
    _conv_layer(out, "final_conv", params["final_conv"], 0)
    _linear(out, "space_linear", params["space_linear"], hwc=True)
    _linear(out, "out_linear", params["out_linear"])
    return _tensors(out)


def jax_triplane_params_to_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """TriplaneRenderer params -> `models/triplane.py` names: the linears
    keep flax's (in, out) layout (the port computes x @ weight + bias)."""
    out = {"sigmoid_beta": _vec(params["sigmoid_beta"])}
    for name, node in params["network"].items():
        out[f"network.{name}.weight"] = _vec(node["weight"])
        out[f"network.{name}.bias"] = _vec(node["bias"])
    return _tensors(out)


def jax_d_pose_params_to_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """DVolumeRenderProgressive (or DVolumeRender) params ->
    `models/discriminator_pose.py` names."""
    out = {}
    for name, node in params.items():
        if name.startswith("conv_in"):
            prefix = _indexed(name, "conv_in")
            out[f"{prefix}.conv.weight"] = _conv(node["weight"])
            out[f"{prefix}.activation.bias"] = _vec(node["bias"])
        elif name.startswith("block_"):
            res = name[len("block_"):]
            for cv in ("conv1", "conv2"):
                out[f"blocks.{res}.{cv}.conv.conv.weight"] = _conv(node[cv]["conv"]["weight"])
                out[f"blocks.{res}.{cv}.activation.bias"] = _vec(node[cv]["conv"]["bias"])
            if "skip" in node:
                out[f"blocks.{res}.skip.conv.weight"] = _conv(node["skip"]["weight"])
                out[f"blocks.{res}.skip.conv.bias"] = _vec(node["skip"]["bias"])
    out["final_conv.conv.weight"] = _conv(params["final_conv"]["weight"])
    out["final_conv.conv.bias"] = _vec(params["final_conv"]["bias"])
    return _tensors(out)


_BRIDGES = {"generator": jax_params_to_state_dict, "d": jax_d_params_to_state_dict,
            "d_pose": jax_d_pose_params_to_state_dict}


def load_jax_params(model: torch.nn.Module, params: Mapping,
                    kind: str = "generator") -> torch.nn.Module:
    """Copy a JAX param tree of `kind` ("generator", "d" or "d_pose") into
    `model` (strict: every key and shape must match)."""
    model.load_state_dict(_BRIDGES[kind](params), strict=True)
    return model


def _adam_states(tree, path=()):
    """(path, node) of each Adam state (a node with count, mu and nu) in an
    optax state tree, walked through named tuples, mappings and tuples."""
    if all(hasattr(tree, a) for a in ("count", "mu", "nu")):
        yield path, tree
        return
    if hasattr(tree, "_asdict"):
        items = tree._asdict().items()
    elif isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return
    for k, v in items:
        yield from _adam_states(v, path + (k,))


def _merge_masked(trees):
    """One tree from trees that each hold some of its arrays and a masked
    node (optax.masked's MaskedNode, which holds none) in place of the rest."""
    live = [t for t in trees if isinstance(t, Mapping) or hasattr(t, "shape")]
    if not live:
        raise ValueError("no group holds this subtree")
    if not isinstance(live[0], Mapping):
        if len(live) != 1:
            raise ValueError("a leaf held by two groups")
        return live[0]
    keys = dict.fromkeys(k for t in live for k in t)
    return {k: _merge_masked([t.get(k) for t in live]) for k in keys}


def _unwrap(variables):
    return variables["params"] if "params" in variables else variables


def _load_adam(opt, named_params, opt_state, to_state_dict):
    """Moments and counts of the optax Adam state(s) in `opt_state` into the
    ClippedAdam `opt`, whose groups take their state by label (a G group
    label appears on the optax path; a single-group D has one state)."""
    found = list(_adam_states(opt_state))
    labels = list(opt.groups)
    by_label = {}
    for path, node in found:
        hit = [k for k in path if k in labels]
        by_label[hit[0] if hit else labels[0]] = node
    if sorted(by_label) != sorted(labels) or len(found) != len(labels):
        raise ValueError(f"optax state holds Adam states {[p for p, _ in found]}, "
                         f"expected one for each of {labels}")
    mu = to_state_dict(_unwrap(_merge_masked([n.mu for n in by_label.values()])))
    nu = to_state_dict(_unwrap(_merge_masked([n.nu for n in by_label.values()])))
    names = {id(p): n for n, p in named_params}
    sd = opt.state_dict()
    state, i = {}, 0
    for label, ps in opt.groups.items():
        count = float(np.asarray(by_label[label].count))
        for p in ps:
            name = names[id(p)]
            state[i] = {"step": torch.tensor(count),
                        "exp_avg": mu[name].reshape(p.shape),
                        "exp_avg_sq": nu[name].reshape(p.shape)}
            i += 1
    opt.load_state_dict({"state": state, "param_groups": sd["param_groups"]})


def load_jax_train_state(state, jax_state):
    """Copy a JAX `TrainState` (cips3dpp_tpu/train/state.py), its arrays as
    numpy (e.g. `jax.tree.map(np.asarray, s)`), into the port's
    `TrainState` `state`, in place: params_g, params_g_ema, params_d and
    params_d_render into g, g_ema, d and d_render; the optax Adam states
    (mu -> exp_avg, nu -> exp_avg_sq, count -> step) of each G group and
    each D into opt_g, opt_d and opt_d_render; mean_path_length and step.
    Then both packages go on from the same state."""
    def get(name):
        return getattr(jax_state, name) if hasattr(jax_state, name) else jax_state[name]

    for mod, name, kind in (("g", "params_g", "generator"), ("g_ema", "params_g_ema", "generator"),
                            ("d", "params_d", "d"), ("d_render", "params_d_render", "d_pose")):
        load_jax_params(getattr(state, mod), _unwrap(get(name)), kind)
    for opt, mod, name, kind in (("opt_g", "g", "opt_g", "generator"),
                                 ("opt_d", "d", "opt_d", "d"),
                                 ("opt_d_render", "d_render", "opt_d_render", "d_pose")):
        _load_adam(getattr(state, opt), list(getattr(state, mod).named_parameters()),
                   get(name), _BRIDGES[kind])
    state.mean_path_length = torch.tensor(float(np.asarray(get("mean_path_length"))),
                                          device=state.mean_path_length.device)
    state.step = int(np.asarray(get("step")))
    return state


def jax_vgg_params_to_state_dict(tree: Mapping) -> dict[str, torch.Tensor]:
    """A flax VGG16Features tree (`{"params": {"conv_{i}": {"kernel" HWIO,
    "bias"}}}` or its params) -> `models/vgg.py` names `features.{i}.*`
    (OIHW); an LPIPS tree (`{"vgg": ..., "lin": {i: (C,)}}`) -> the LPIPS
    module's `vgg.features.{i}.*` and `lin.{i}`."""
    if "vgg" in tree:
        out = {f"vgg.{k}": v for k, v in jax_vgg_params_to_state_dict(tree["vgg"]).items()}
        out.update(_tensors({f"lin.{i}": _vec(w) for i, w in tree["lin"].items()}))
        return out
    params = _unwrap(tree)
    out = {}
    for name, node in params.items():
        idx = name[len("conv_"):]
        out[f"features.{idx}.weight"] = _conv(node["kernel"])
        out[f"features.{idx}.bias"] = _vec(node["bias"])
    return _tensors(out)


def jax_inception_to_state_dict(variables: Mapping) -> dict[str, torch.Tensor]:
    """The JAX package's InceptionV3Features variables (`{"params": ...,
    "batch_stats": ...}`, each `{block: {branch: {"conv"|"bn": ...}}}` or
    `{stem: ...}`) -> pt_inception's state-dict names, the port's
    `models/inception.py` (the inverse of the JAX package's
    `import_torch_inception`)."""
    out = {}

    def walk(pnode, snode, prefix):
        if "conv" in pnode:
            out[f"{prefix}.conv.weight"] = _conv(pnode["conv"]["kernel"])
            out[f"{prefix}.bn.weight"] = _vec(pnode["bn"]["scale"])
            out[f"{prefix}.bn.bias"] = _vec(pnode["bn"]["bias"])
            out[f"{prefix}.bn.running_mean"] = _vec(snode["bn"]["mean"])
            out[f"{prefix}.bn.running_var"] = _vec(snode["bn"]["var"])
            return
        for name, child in pnode.items():
            walk(child, snode[name], f"{prefix}.{name}" if prefix else name)

    walk(variables["params"], variables["batch_stats"], "")
    return _tensors(out)


class _ArrayUnpickler(pickle.Unpickler):
    """Unpickles dicts, lists and numpy arrays, and nothing that runs code."""

    _ALLOWED = {("numpy", "ndarray"), ("numpy", "dtype"),
                ("numpy.core.multiarray", "_reconstruct"),
                ("numpy._core.multiarray", "_reconstruct")}

    def find_class(self, module, name):
        if (module, name) not in self._ALLOWED:
            raise pickle.UnpicklingError(f"{module}.{name} is not allowed in an inversion "
                                         "artifact")
        return super().find_class(module, name)


def load_jax_inversion(path: str) -> dict:
    """An inversion artifact the JAX package wrote (`Projector.save_inversion`:
    a pickle of numpy trees under flax names, cips3dpp_tpu/apps/
    inversion.py:445-451) in the port's artifact layout
    (`apps/inversion.py` `Projector.save_inversion`)."""
    with open(path, "rb") as f:
        blob = _ArrayUnpickler(f).load()
    t = lambda x: torch.from_numpy(np.array(x, np.float32))

    def strip(sd, prefix):
        return {k[len(prefix):]: v for k, v in sd.items()}

    out = {k: t(blob[k]) for k in ("azim", "elev", "w_render_opt", "w_decoder_opt")}
    out["decoder_params"] = strip(jax_params_to_state_dict(
        {"decoder": blob["decoder_params"]}), "decoder.")
    if "renderer_params" in blob:
        out["renderer_params"] = strip(jax_params_to_state_dict(
            {"renderer": blob["renderer_params"]}), "renderer.")
    out["noise_bufs"] = [t(b) for b in blob["noise_bufs"]]
    return out
