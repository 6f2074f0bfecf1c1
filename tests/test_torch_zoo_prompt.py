"""The port's prompt processor and the zoo's corner hash grid against the
JAX package (CPU).

- Bit-equal: ``_hash_embedding`` and ``hash_prompt`` on a corpus of prompts;
  ``PromptEmbeddings.get`` at elevations and azimuths on and around every
  threshold (front 45°, back 45°, overhead 60°, the ±180° wrap), with and
  without view-dependent prompting; ``get_debiased_prompt`` with the hash
  probe (all words, and ``prompt_debiasing_mask_ids``); the processor's
  embeddings with debiasing on, and with a cached ``.npy`` in the cache
  directory (read in place of the hash).
- Refused with ``RuntimeError`` naming ROADMAP A8: a tokenizer directory
  whose embeddings are not cached, a BERT directory for debiasing,
  ``use_text_encoder`` and ``encode_tokens``.
- The corner layout at the zoo YAMLs' widths (16 levels × 2 features,
  2^19 rows, base 16, scale 1.447): every level's eight corner indices of
  4,096 points equal the JAX ``_hash_corner``'s, and ``hashgrid_encode``
  on the same tables within 1e-6 of its max.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreammesh4d_tpu.models.guidance import stable_diffusion as jsd
from dreammesh4d_tpu.ops import hashgrid as jhg
from dreammesh4d_tpu_torch.models.guidance import stable_diffusion as psd
from dreammesh4d_tpu_torch.ops import hashgrid as phg

PROMPTS = ["a test object", "", "a DSLR photo of a corgi, front view", "ünïcødé 🦊 prompt",
           "a zoomed out DSLR photo of a hamburger on a plate, overhead view"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_hashes_are_bit_equal():
    for p in PROMPTS:
        np.testing.assert_array_equal(psd._hash_embedding(p, 77, 32), jsd._hash_embedding(p, 77, 32))
        assert psd.hash_prompt("load/stable-diffusion-v1-5", p) == jsd.hash_prompt("load/stable-diffusion-v1-5", p)


@pytest.mark.parametrize("view_dependent", [True, False])
def test_view_rows_are_bit_equal(view_dependent):
    el = np.float32([0, 59.999, 60.0, 60.001, 89.0, -10.0, 30.0, 30.0, 30.0, 30.0, 30.0, 30.0, 30.0, 30.0])
    az = np.float32([0, 44.999, 45.0, 45.001, -45.0, 134.999, 135.0, 135.001, 180.0, -180.0, 225.0, -225.0,
                     359.0, -135.0])
    rng = np.random.default_rng(0)
    cond, uncond = rng.normal(size=(5, 3, 4)).astype(np.float32), rng.normal(size=(3, 4)).astype(np.float32)
    kw = dict(use_view_dependent_prompting=view_dependent)
    jc, ju = jsd.PromptEmbeddings(jnp.asarray(cond), jnp.asarray(uncond), jsd.PromptProcessorConfig(**kw)).get(
        jnp.asarray(el), jnp.asarray(az))
    pe = psd.PromptEmbeddings(torch.as_tensor(cond), torch.as_tensor(uncond), psd.PromptProcessorConfig(**kw))
    c, u = pe.get(torch.as_tensor(el), torch.as_tensor(az))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
    rows = pe.view_index(torch.as_tensor(el), torch.as_tensor(az)).tolist()
    if view_dependent:
        assert set(rows) == {1, 2, 3, 4}
    else:
        assert set(rows) == {0}


@pytest.mark.parametrize("mask_ids", [None, (1, 3)])
def test_debiased_prompt_is_equal(mask_ids):
    prompt = "a zoomed out DSLR photo of a hamburger on a plate"
    kw = dict(prompt=prompt, prompt_debiasing_mask_ids=mask_ids, use_prompt_debiasing=True)
    got = psd.StableDiffusionPromptProcessor(kw, device="cpu").get_debiased_prompt(prompt)
    want = jsd.StableDiffusionPromptProcessor(kw).get_debiased_prompt(prompt)
    assert got == want and len(got) == 4
    if mask_ids is None:
        assert any(p != prompt for p in got)  # the probe drops words somewhere


def _embeddings_equal(kw):
    pe = psd.StableDiffusionPromptProcessor(kw, device="cpu")()
    je = jsd.StableDiffusionPromptProcessor(kw)()
    np.testing.assert_array_equal(pe.cond.numpy(), np.asarray(je.cond))
    np.testing.assert_array_equal(pe.uncond.numpy(), np.asarray(je.uncond))
    return pe


def test_embeddings_with_debiasing_and_a_cache_file(tmp_path):
    kw = dict(prompt="a DSLR photo of a corgi", negative_prompt="blurry", context_dim=16, seq_len=5,
              use_prompt_debiasing=True, cache_dir=str(tmp_path))
    pe = _embeddings_equal(kw)
    assert pe.cond.shape == (5, 5, 16) and pe.uncond.shape == (5, 16)
    np.testing.assert_array_equal(pe.uncond.numpy(), jsd._hash_embedding("blurry", 5, 16))
    cached = np.full((5, 16), 0.25, np.float32)
    np.save(tmp_path / f"{psd.hash_prompt('', 'blurry')}.npy", cached)
    pe = _embeddings_equal(kw)
    np.testing.assert_array_equal(pe.uncond.numpy(), cached)


def test_refusals_name_a8(tmp_path):
    tok = tmp_path / "sd"
    tok.mkdir()
    (tok / "tokenizer_config.json").write_text("{}")
    with pytest.raises(RuntimeError, match="A8"):
        psd.StableDiffusionPromptProcessor(dict(pretrained_model_name_or_path=str(tok),
                                                cache_dir=str(tmp_path / "cache")), device="cpu")()
    bert = tmp_path / "bert"
    bert.mkdir()
    with pytest.raises(RuntimeError, match="A8"):
        psd.StableDiffusionPromptProcessor(dict(use_prompt_debiasing=True,
                                                pretrained_model_name_or_path_prompt_debiasing=str(bert)),
                                           device="cpu")()
    with pytest.raises(RuntimeError, match="A8"):
        psd.StableDiffusionGuidance(dict(use_text_encoder=True), device="cpu")
    with pytest.raises(RuntimeError, match="A8"):
        psd.StableDiffusionGuidance(dict(model_channels=8, channel_mult=[1], num_heads=1, context_dim=8,
                                         vae_ch=8, vae_ch_mult=[1]), device="cpu").encode_tokens(None)


def test_corner_hash_at_the_zoo_widths():
    cfg = phg.HashGridConfig(n_levels=16, n_features_per_level=2, log2_hashmap_size=19)
    jcfg = jhg.HashGridConfig(n_levels=16, n_features_per_level=2, log2_hashmap_size=19)
    T = 1 << 19
    assert cfg.level_resolutions() == jcfg.level_resolutions()
    x = np.random.default_rng(1).random((4096, 3), dtype=np.float32)
    hashed = 0
    for res in cfg.level_resolutions():
        x0 = np.clip(np.floor(x * res), 0, res - 1).astype(np.int64)
        for corner in range(8):
            c = x0 + np.array([corner & 1, (corner >> 1) & 1, (corner >> 2) & 1])
            got = phg._hash_corner(*(torch.as_tensor(c[:, i]) for i in range(3)), res, T).numpy()
            want = np.asarray(jhg._hash_corner(*(jnp.asarray(c[:, i].astype(np.int32)) for i in range(3)),
                                               res, T))
            np.testing.assert_array_equal(got, want.astype(np.int64))
            assert got.min() >= 0 and got.max() < T
        hashed += (res + 1) ** 3 > T
    assert hashed >= 8  # the fine levels hash, the coarse ones index densely
    tables = np.random.default_rng(2).uniform(-1, 1, (16, T, 2)).astype(np.float32)
    want = np.asarray(jhg.hashgrid_encode({"tables": jnp.asarray(tables)}, jcfg, jnp.asarray(x)))
    got = phg.hashgrid_encode({"tables": torch.as_tensor(tables)}, cfg, torch.as_tensor(x)).numpy()
    assert got.shape == (4096, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
