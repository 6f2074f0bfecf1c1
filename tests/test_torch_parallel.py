"""The port's process grid and tensor parallelism (counterpart of
``tests/test_sharding.py`` and of ``dreammesh4d_tpu/parallel/``).

- ``plan_from_trainer_cfg`` / ``ParallelContext.from_trainer_cfg`` against
  the JAX package's ``ParallelContext.from_trainer_cfg`` on a table of
  ``trainer.devices`` / ``trainer.mesh`` values, with the port's visible
  count at the 8 virtual devices of the JAX tests: the same (dp, tp), and
  the same errors ("visible", "factor", "divisible");
- the UNet's column / row role of every attention and FF weight against
  JAX ``sharding_rules._spec_for`` on the same tiny UNet;
- the tensor-parallel UNet and SDS loss of two shards (each in a thread of
  this process, the row-parallel sums exchanged through a barrier; the
  launcher test runs the real ``gloo`` group) within 1e-5 of the unsplit
  ones, in float32 and bfloat16 (JAX ``test_sharding.py`` asks 1e-4);
- ``shard_batch`` keeps the rank's rows and replicates an indivisible leaf.
"""

import threading
from collections import Counter

import numpy as np
import pytest
import torch

from dreammesh4d_tpu_torch.parallel import context as pctx
from dreammesh4d_tpu_torch.parallel.context import ParallelContext, check_batch_size, plan_from_trainer_cfg
from dreammesh4d_tpu_torch.parallel.mesh import shard_batch
from dreammesh4d_tpu_torch.parallel.sharding_rules import role_for

torch.set_num_threads(1)

TINY = dict(model_channels=16, channel_mult=(1, 2), num_res_blocks=1, num_heads=4, context_dim=16,
            vae_ch=8, vae_ch_mult=(1, 2), vae_num_res_blocks=1, image_size=16, use_clip=False)

TABLE = [({}, None), ({"devices": 1}, None), ({"devices": 1, "mesh": [1, 1]}, None),
         ({"devices": 2}, (2, 1)), ({"devices": 4, "mesh": [2, 2]}, (4, 2, 2)),
         ({"devices": 8, "mesh": [2, 4]}, (8, 2, 4)), ({"devices": "auto"}, (8, 8, 1)),
         ({"devices": -1, "mesh": [4, 2]}, (8, 4, 2)), ({"devices": 8, "mesh": [3, 2]}, "factor"),
         ({"devices": 4, "mesh": [1, 2]}, "factor"), ({"devices": 16}, "visible")]


@pytest.mark.parametrize("tcfg,want", TABLE)
def test_plan_matches_jax_context(tcfg, want, monkeypatch):
    import jax

    from dreammesh4d_tpu.parallel.context import ParallelContext as JaxContext

    assert len(jax.devices()) == 8  # the conftest's virtual devices
    monkeypatch.setattr(pctx, "visible_devices", lambda device: 8)
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            JaxContext.from_trainer_cfg(tcfg)
        with pytest.raises(ValueError, match=want):
            plan_from_trainer_cfg(tcfg, "cpu")
        return
    jctx = JaxContext.from_trainer_cfg(tcfg)
    plan = plan_from_trainer_cfg(tcfg, "cpu")
    if want is None:
        assert plan is None and not jctx.active
        assert not ParallelContext.from_trainer_cfg(tcfg, "cpu").active  # no process group made
        return
    if len(want) == 2:
        want = (want[0], want[0], want[1])
    assert plan == want and (jctx.dp, jctx.tp) == want[1:]
    with pytest.raises(RuntimeError, match="launcher"):  # ranks come from the launcher
        ParallelContext.from_trainer_cfg(tcfg, "cpu")


def test_batch_divisibility_matches_jax():
    import jax

    from dreammesh4d_tpu.parallel.context import ParallelContext as JaxContext

    jctx = JaxContext.from_trainer_cfg({"devices": 2})
    for sizes in (3, [4, 3]):
        with pytest.raises(ValueError, match="divisible"):
            jctx.check_batch_size(sizes, "data.random_camera.batch_size")
        with pytest.raises(ValueError, match="divisible"):
            check_batch_size(sizes, 2, "data.random_camera.batch_size")
    jctx.check_batch_size([8, 4, 2], "x")
    check_batch_size([8, 4, 2], 2, "x")
    assert len(jax.devices()) == 8


def _jax_roles():
    """(block weight, role) of every attention / FF kernel of the JAX UNet
    by ``_spec_for`` on a 2-way model axis (shapes only)."""
    import jax
    from jax.sharding import PartitionSpec as P

    from dreammesh4d_tpu.models.guidance.zero123 import StableZero123Guidance, Zero123Config
    from dreammesh4d_tpu.parallel.sharding_rules import _spec_for

    g = StableZero123Guidance(Zero123Config(**TINY))
    shapes = jax.eval_shape(g.modules.init_params, jax.random.PRNGKey(0))
    names = {"to_q": "to_q", "to_k": "to_k", "to_v": "to_v", "to_out": "to_out.0",
             "proj_in": "net.0.proj", "proj_out": "net.2"}
    roles = Counter()
    for path, x in jax.tree_util.tree_flatten_with_path(shapes["unet"])[0]:
        keys = [str(getattr(p, "key", p)) for p in path]
        if keys[-1] != "kernel" or not any(k in ("attn1", "attn2", "ff") for k in keys):
            continue
        spec = _spec_for("/".join(keys), x, 2)
        role = {P(None, "model"): "column", P("model", None): "row"}.get(spec)
        roles[(f"{keys[-3]}.{names[keys[-2]]}", role)] += 1
    return roles


def test_unet_roles_match_jax_spec_for():
    from dreammesh4d_tpu_torch.models.guidance.zero123.unet import UNetModel

    with torch.device("meta"):
        unet = UNetModel(model_channels=16, channel_mult=(1, 2), num_res_blocks=1, num_heads=4,
                         context_dim=16)
    roles = Counter()
    for name, _ in unet.named_parameters():
        role = role_for(name)
        if role is not None:
            parts = name[:-len(".weight")].split(".")
            block = parts[parts.index("transformer_blocks") + 2]
            roles[(f"{block}.{'.'.join(parts[parts.index(block) + 1:])}", role)] += 1
        else:  # outside the attention / FF weights everything stays whole
            assert "transformer_blocks" not in name or not name.endswith(
                ("to_q.weight", "to_k.weight", "to_v.weight", "to_out.0.weight", "net.0.proj.weight",
                 "net.2.weight")), name
    jax_roles = _jax_roles()
    assert roles == jax_roles
    assert roles[("attn1.to_q", "column")] == roles[("ff.net.2", "row")] > 0


class _Pair:
    """The model group of two shards run in two threads of this process:
    ``all_reduce_`` of a row-parallel layer becomes an exchange through a
    barrier, summed in rank order (``tests/test_torch_launch_multidevice.py``
    runs the real ``gloo`` group)."""

    def __init__(self):
        self.barrier = threading.Barrier(2)
        self.parts = [None, None]
        self.local = threading.local()

    def all_reduce_(self, x, group, op=None):
        assert group is self
        self.parts[self.local.m] = x.clone()
        self.barrier.wait()
        total = self.parts[0] + self.parts[1]
        self.barrier.wait()
        with torch.no_grad():
            x.copy_(total)
        return x


def _sds_case(dtype):
    from dreammesh4d_tpu_torch.models.guidance.zero123.guidance import StableZero123Guidance, Zero123Config

    g = StableZero123Guidance(Zero123Config(**TINY, dtype=dtype), device="cpu")
    g.modules.init_params(torch.Generator().manual_seed(0), zero_init=False)
    gen = torch.Generator().manual_seed(1)
    inputs = dict(x=torch.randn(2, 8, 8, 8, generator=gen), t=torch.tensor([10, 500]),
                  ctx=torch.randn(2, 1, 16, generator=gen),
                  rgb=torch.rand(2, 20, 20, 3, generator=gen),
                  bank=g.prepare_embeddings(torch.rand(1, 16, 16, 3, generator=gen)))
    return g, inputs


def _run_sds(g, inp):
    eps = g.modules.unet(inp["x"], inp["t"], inp["ctx"])
    rgb = inp["rgb"].clone().requires_grad_(True)
    cams = (torch.tensor([10.0, 20.0]), torch.tensor([0.0, 90.0]), torch.tensor([1.2, 1.2]))
    loss = g.sds_loss(inp["bank"], rgb, *cams, None, 100, torch.Generator().manual_seed(3))["loss_sds"]
    (grad,) = torch.autograd.grad(loss, rgb)
    return eps, loss.detach(), grad


@pytest.mark.parametrize("dtype,eps_tol", [("float32", 1e-5), ("bfloat16", 1e-2)])
def test_tensor_parallel_unet_and_sds_match_single(dtype, eps_tol, monkeypatch):
    """The UNet split over a model axis of 2 (each shard in its own thread,
    ``shard_unet`` on a copy of the same weights): the noise prediction
    within ``eps_tol`` of its max (bf16 rounds the column products another
    way), the SDS loss and its gradient in the render within 1e-5."""
    import copy

    from dreammesh4d_tpu_torch.parallel import sharding_rules
    from dreammesh4d_tpu_torch.parallel.mesh import ProcessGrid

    g, inp = _sds_case(dtype)
    full = _run_sds(g, inp)
    pair = _Pair()
    monkeypatch.setattr(sharding_rules, "all_reduce_", pair.all_reduce_)
    shards, results, errors = [copy.deepcopy(g) for _ in range(2)], [None, None], []

    def run(m):
        try:
            pair.local.m = m
            ParallelContext(ProcessGrid(1, 2, m, None, pair)).shard_guidance(shards[m])
            results[m] = _run_sds(shards[m], inp)
        except Exception as e:  # reported below, after both threads end
            errors.append(e)
            pair.barrier.abort()

    threads = [threading.Thread(target=run, args=(m,)) for m in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors, errors
    unet0 = shards[0].modules.unet.middle_block[1].transformer_blocks[0]
    assert unet0.attn1.to_q.out_features == 16 and unet0.ff.net[0].proj.out_features == 128
    assert float(full[0].abs().max()) > 0.1  # the split layers reach the output
    for m in range(2):
        eps, loss, grad = results[m]
        assert float((eps - full[0]).abs().max() / full[0].abs().max()) < eps_tol, m
        assert float((loss - full[1]).abs() / full[1].abs()) < 1e-5, m
        assert float((grad - full[2]).abs().max() / full[2].abs().max()) < 1e-5, m


def test_shard_batch_keeps_rows_and_replicates_indivisible_leaves():
    cams = (torch.arange(8.0).reshape(4, 2), torch.arange(4))
    batch = {"rand_cameras": cams, "ref": torch.ones(1, 3), "inter": torch.arange(3.0),
             "step": 7, "scalar": torch.tensor(2.0)}
    out = shard_batch(batch, 2, 1)
    assert torch.equal(out["rand_cameras"][0], cams[0][2:]) and torch.equal(out["rand_cameras"][1], cams[1][2:])
    assert out["ref"] is batch["ref"] and out["inter"] is batch["inter"] and out["step"] == 7
    assert out["scalar"] is batch["scalar"]
    assert ParallelContext().shard_batch(batch) is batch
    np.testing.assert_array_equal(shard_batch(batch, 4, 3)["rand_cameras"][1].numpy(), [3])
