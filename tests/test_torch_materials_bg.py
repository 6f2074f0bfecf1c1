"""The port's materials and backgrounds (``models/materials.py``,
``models/background.py``) and ``utils/misc.get_activation`` against the JAX
package's (CPU).

- ``get_activation``: every name of the table, ``scale_*`` and ``clamp_*``,
  within 1e-6 (and an unknown name refused by both);
- ``PBRMaterial``'s environment pyramid (the default sky and a random
  map, ``n_levels − 1`` 5-tap box blurs along H then W) within 1e-5;
- each of the 8 names built by ``registry.find(name)(cfg, device="cpu")``
  on the JAX package's parameters (``init_params``, carried by
  ``convert.component_params``): the forward within 1e-5, and the
  gradients of a weighted sum of it with respect to the features and every
  parameter within 1e-4 of each one's max.  The directions include the
  azimuth seam (the wrapped column) and the poles; ``pbr-material`` runs
  with a tangent (the bump path) and without; the random-colour
  augmentation takes the JAX draws, once on each side of its probability.

Each JAX forward + gradient runs under one ``jax.jit`` (compiled with XLA's
cheaper optimisation level).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_compile import FAST_COMPILE

from dreammesh4d_tpu.models import background as jbg
from dreammesh4d_tpu.models import materials as jmat
from dreammesh4d_tpu.utils.misc import get_activation as jax_activation
from dreammesh4d_tpu_torch import convert
from dreammesh4d_tpu_torch.models import background as pbg
from dreammesh4d_tpu_torch.models import materials as pmat
from dreammesh4d_tpu_torch.registry import find
from dreammesh4d_tpu_torch.utils.misc import get_activation

N = 48


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    print(f"{what}: max |d| / max |ref| = {err:.3g} (band {rel:g})")
    assert err <= rel, (what, err)


def _unit(rng, n):
    d = rng.normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(31)
    dirs = _unit(rng, N)
    # the azimuth seam on both sides (the last column wraps to the first) and near the poles
    edge = np.float32([[1.0, -1e-3, 0.2], [1.0, 1e-3, -0.3], [0.3, -2e-3, 0.9], [1e-3, 1e-3, 0.999],
                       [-1e-3, 2e-3, -0.999], [-0.5, -1e-3, 0.1]])
    dirs[:len(edge)] = edge / np.linalg.norm(edge, axis=-1, keepdims=True)
    poles = dirs.copy()
    poles[:2] = [[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]]  # exact poles: the clamped rows
    return {"feat8": rng.normal(size=(N, 8)).astype(np.float32), "feat7": rng.normal(size=(N, 7)).astype(np.float32),
            "feat4": rng.normal(size=(N, 4)).astype(np.float32), "dirs": dirs, "poles": poles,
            "view": _unit(rng, N), "tangent": _unit(rng, N), "w": rng.normal(size=(N, 3)).astype(np.float32)}


def test_get_activation_matches_jax():
    x = np.linspace(-4.0, 4.0, 41, dtype=np.float32)
    x[20] = 0.002  # below lin2srgb's knee
    names = [None, "none", "lin2srgb", "exp", "trunc_exp", "shifted_trunc_exp", "sigmoid", "tanh", "softplus",
             "shifted_softplus", "relu", "silu", "SIGMOID", "scale_-11.0", "scale_0.5", "clamp_-1.0_2.5"]
    wants = jax.jit(lambda v: [jax_activation(name)(v) for name in names])(x)
    for name, want in zip(names, wants):
        got = get_activation(name)(torch.as_tensor(x)).numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6, err_msg=str(name))
    for fn in (get_activation, jax_activation):
        with pytest.raises(ValueError, match="Unknown activation"):
            fn("gelu_new")


def test_pbr_env_pyramid_matches_jax():
    rng = np.random.default_rng(32)
    envmap = rng.random((8, 12, 3), dtype=np.float32)
    for cfg, env in (({}, None), ({"env_height": 8, "env_width": 12, "n_levels": 3, "environment_scale": 1.5}, envmap)):
        jm = jmat.PBRMaterial(**cfg)
        want = np.asarray(jm.init_params(jax.random.PRNGKey(0), envmap=env)["env_levels"])
        got = find("pbr-material")(cfg, device="cpu", envmap=env).params["env_levels"].numpy()
        assert got.shape == want.shape == (jm.n_levels, jm.env_height, jm.env_width, 3)
        _close(got, want, 1e-5, f"env_levels {got.shape}")
        assert not np.allclose(got[0], got[-1])  # the levels are blurred


# name: (config, the JAX class, (feature key or None, the other inputs), call kind)
CASES = {
    "pbr-material": ({"env_height": 16, "env_width": 24}, jmat.PBRMaterial, "feat8", "pbr"),
    "pbr-material/no-bump": ({"env_height": 16, "env_width": 24}, jmat.PBRMaterial, "feat8", "pbr_flat"),
    "neural-radiance-material": ({"n_neurons": 16}, jmat.NeuralRadianceMaterial, "feat8", "radiance"),
    "hybrid-rgb-latent-material": ({}, jmat.HybridRGBLatentMaterial, "feat7", "plain"),
    "sd-latent-adapter-material": ({}, jmat.SDLatentAdapterMaterial, "feat4", "adapter"),
    "neural-environment-map-background": ({}, jbg.NeuralEnvironmentMapBackground, None, "envmap"),
    "gaussian-mvdream-neural-environment-map-background": ({"n_frequencies": 4}, jbg.NeuralEnvironmentMapBackground,
                                                           None, "envmap"),
    "solid-color-background": ({"learned": True, "color": (0.2, 0.5, 0.9)}, jbg.SolidColorBackground, None, "solid"),
    "textured-background": ({"height": 8, "width": 16}, jbg.TexturedBackground, None, "textured"),
}


def _jax_params(jobj, kind):
    if kind in ("plain",):
        return {}
    if kind == "solid":
        return jobj.init_params()
    return jobj.init_params(jax.random.PRNGKey(3))


def _jax_call(jobj, kind, feat, params, x):
    if kind == "pbr":
        return jobj(feat, viewdirs=x["view"], shading_normal=x["dirs"], tangent=x["tangent"], params=params)
    if kind == "pbr_flat":
        return jobj(feat, viewdirs=x["view"], shading_normal=x["dirs"], params=params)
    if kind == "radiance":
        return jobj(feat, viewdirs=x["dirs"], params=params)
    if kind == "plain":
        return jobj(feat)
    if kind == "adapter":
        return jobj(feat, params=params)
    if kind == "envmap":
        return jobj(params, x["dirs"])
    if kind == "solid":
        return jnp.broadcast_to(jobj(params), (N, 3))
    return jobj(params, x["poles"])


def _port_call(obj, kind, feat, params, x):
    t = {k: torch.as_tensor(v) for k, v in x.items()}
    if kind == "pbr":
        return obj(feat, viewdirs=t["view"], shading_normal=t["dirs"], tangent=t["tangent"], params=params)
    if kind == "pbr_flat":
        return obj(feat, viewdirs=t["view"], shading_normal=t["dirs"], params=params)
    if kind == "radiance":
        return obj(feat, viewdirs=t["dirs"], params=params)
    if kind == "plain":
        return obj(feat)
    if kind == "adapter":
        return obj(feat, params=params)
    if kind == "envmap":
        return obj(t["dirs"], params=params)
    if kind == "solid":
        return obj(params=params).expand(N, 3)
    return obj(t["poles"], params=params)


@pytest.mark.parametrize("case", sorted(CASES))
def test_component_matches_jax(inputs, case):
    cfg, jcls, fkey, kind = CASES[case]
    name = case.split("/")[0]
    obj = find(name)(cfg, device="cpu")
    assert type(obj).__name__ == jcls.__name__ and type(obj).__module__.endswith(jcls.__module__.split(".")[-1])
    jobj = jcls(**{k: v for k, v in cfg.items() if k in {f.name for f in dataclasses.fields(jcls)}})
    jparams = jax.tree.map(np.asarray, _jax_params(jobj, kind))
    feat_np = inputs[fkey] if fkey else np.zeros((N, 1), np.float32)
    w = inputs["w"]

    def j_loss(feat, params):
        out = _jax_call(jobj, kind, feat, params, inputs)
        return (out[..., :3] * w).sum(), out

    fn = jax.value_and_grad(j_loss, argnums=(0, 1), has_aux=True)
    (_, jout), (jg_feat, jg_params) = jax.jit(fn).lower(feat_np, jparams).compile(FAST_COMPILE)(feat_np, jparams)
    params = convert.component_params(jparams, device="cpu")
    shapes = lambda tree: jax.tree.map(lambda v: tuple(np.shape(v)), tree)  # noqa: E731
    assert shapes(obj.params) == shapes(jparams)  # the port's own draw has the JAX tree's layout
    feat = torch.tensor(feat_np, requires_grad=True)
    out = _port_call(obj, kind, feat, params, inputs)
    (out[..., :3] * torch.as_tensor(w)).sum().backward()
    _close(out.detach().numpy(), jout, 1e-5, f"{case} forward")
    if fkey:
        _close(feat.grad.numpy(), jg_feat, 1e-4, f"{case} d / d features")
    for path, g in jax.tree_util.tree_leaves_with_path(jg_params):
        leaf = params
        for key in path:
            leaf = leaf[key.key if hasattr(key, "key") else key.idx]
        _close(leaf.grad.numpy(), np.asarray(g), 1e-4, f"{case} d / d {jax.tree_util.keystr(path)}")
    if kind == "pbr":
        np.testing.assert_allclose(
            np.asarray(jnp.concatenate(list(jobj.export(feat_np).values()), -1)),
            torch.cat(list(obj.export(torch.as_tensor(feat_np)).values()), -1).numpy(), atol=1e-6)


@pytest.mark.parametrize("name", ["neural-environment-map-background", "solid-color-background"])
def test_random_aug_takes_the_jax_draws(inputs, name):
    """With ``training`` and ``random_aug`` both packages pick the random
    colour where the uniform is below ``random_aug_prob``: the port given
    the JAX draws (split(rng) → the colour, then the uniform)."""
    cfg = {"random_aug": True, "random_aug_prob": 0.5}
    obj = find(name)(cfg, device="cpu")
    jcls = jbg.NeuralEnvironmentMapBackground if name.startswith("neural") else jbg.SolidColorBackground
    jobj = jcls(**cfg)
    jparams = _jax_params(jobj, "solid" if name.startswith("solid") else "envmap")
    params = convert.component_params(jax.tree.map(np.asarray, jparams), device="cpu")
    picked = set()
    for seed in range(8):
        rng = jax.random.PRNGKey(seed)
        k1, k2 = jax.random.split(rng)
        rand_color, u = np.asarray(jax.random.uniform(k1, (3,))), np.asarray(jax.random.uniform(k2))
        args = (jparams, inputs["dirs"]) if name.startswith("neural") else (jparams,)
        want = np.asarray(jobj(*args, rng=rng, training=True))
        kw = dict(params=params, training=True, rand_color=torch.as_tensor(rand_color), u=torch.as_tensor(u))
        got = (obj(torch.as_tensor(inputs["dirs"]), **kw) if name.startswith("neural") else obj(**kw)).detach()
        np.testing.assert_allclose(got.numpy(), np.broadcast_to(want, got.shape), atol=1e-6)
        picked.add(bool(u < 0.5))
    assert picked == {True, False}
    # and from a generator: the colour is one of the two
    gen = torch.Generator().manual_seed(0)
    for _ in range(4):
        c = obj(torch.as_tensor(inputs["dirs"]), params=params, generator=gen, training=True) if name.startswith(
            "neural") else obj(params=params, generator=gen, training=True)
        assert c.shape[-1] == 3 and bool(((c >= 0) & (c <= 1)).all())


GUIDANCE_TINY = dict(model_channels=8, channel_mult=(1,), num_res_blocks=1, num_heads=2, context_dim=8, vae_ch=8,
                     vae_ch_mult=(1,), vae_num_res_blocks=1, image_size=8, latent_size=8, use_clip=False)
ON_DEVICE = {  # the 10 names of this slice that place tensors at construction, with a config
    "stable-diffusion-unified-guidance": GUIDANCE_TINY, "zero123-unified-guidance": GUIDANCE_TINY,
    "pbr-material": {}, "neural-radiance-material": {}, "sd-latent-adapter-material": {},
    "neural-environment-map-background": {}, "gaussian-mvdream-neural-environment-map-background": {},
    "solid-color-background": {"learned": True}, "textured-background": {}}


@pytest.mark.parametrize("name", sorted(ON_DEVICE))
def test_built_on_cuda_by_default(name):
    """``registry.find(name)(cfg)`` places the component on ``cuda``:
    without a card it raises; with ``device="cpu"`` every tensor is there."""
    if torch.cuda.is_available():
        find(name)(ON_DEVICE[name])
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            find(name)(ON_DEVICE[name])
    obj = find(name)(ON_DEVICE[name], device="cpu")
    tensors = list(obj.modules.state_dict().values()) if hasattr(obj, "modules") else jax.tree.leaves(
        obj.params, is_leaf=torch.is_tensor)
    assert tensors and all(t.device.type == "cpu" for t in tensors)


def test_port_defaults():
    """Parameters are drawn from a generator seeded by ``cfg["seed"]``; the
    names resolve to the port's classes."""
    a = find("textured-background")({"seed": 4}, device="cpu").params["texture"]
    b = find("textured-background")({"seed": 4}, device="cpu").params["texture"]
    c = find("textured-background")({"seed": 5}, device="cpu").params["texture"]
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert isinstance(find("pbr-material"), type) and find("pbr-material") is pmat.PBRMaterial
    assert find("gaussian-mvdream-neural-environment-map-background") is pbg.NeuralEnvironmentMapBackground
