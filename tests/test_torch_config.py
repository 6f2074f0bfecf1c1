"""The port's YAML module, config loader and registry against PyYAML and the
JAX package's loader (CPU).

- ``yaml_lite.safe_load`` equals ``yaml.safe_load`` on each of the 13 YAMLs
  under ``configs/`` and on a corpus of scalars and small documents: YAML 1.1
  numbers (``1.e-15`` and ``5000.`` floats, ``1e-15`` a string, ``.inf``,
  underscores, octal, hex, base 60), the booleans and nulls in their
  spellings, quoted strings, ``???``, flow lists and maps, block sequences at
  their key's indentation, comments.  Equality is exact and type-strict
  (``64`` is not ``64.0``).
- ``safe_dump`` round-trips through both readers.
- Constructs outside the subset raise ``YAMLError``; on seeded random text
  the reader gives PyYAML's value or raises, never another value.
- ``load_config`` of the port equals ``config_to_primitive`` of the JAX
  ``load_config`` on the three shipped YAMLs with the dotlists of
  ``run_recovery`` (``tests/test_recovery_benchmark.py``) and
  ``tests/test_launch_dynamic.py``, ``use_timestamp=false``, and on the six
  zoo YAMLs the port runs (prompts and an image path with spaces through
  the ``rmspace`` / ``basename`` tags, imagecondition's ``???`` prompt
  left in place); the ``parsed.yaml`` that
  ``dump_config`` writes loads back to the same config.
- The registry resolves the names the stages use; a name not ported yet
  raises ``KeyError``.
"""

import dataclasses
import glob
import math
import os

import pytest
import torch
import yaml

from dreammesh4d_tpu.config import config_to_primitive as j_config_to_primitive
from dreammesh4d_tpu.config import load_config as j_load_config
from dreammesh4d_tpu_torch import registry
from dreammesh4d_tpu_torch.config import config_to_primitive, dump_config, load_config
from dreammesh4d_tpu_torch.utils import yaml_lite

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """With several test workers on the cores, torch's intra-op pool would
    oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "**", "*.yaml"), recursive=True))


def same(a, b) -> bool:
    """Equal values of equal types, NaN equal to NaN, dict key order included."""
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b


def test_all_configs_are_read():
    assert len(CONFIGS) == 13


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: os.path.relpath(p, REPO))
def test_config_files_parse_as_pyyaml(path):
    with open(path) as f:
        text = f.read()
    assert same(yaml_lite.safe_load(text), yaml.safe_load(text))


CORPUS = [
    # YAML 1.1 floats: a dot, or a signed exponent after a dot
    "1.e-15", "5000.", ".5", "0.", "-1_000.5", "1.0e-15", "1.5E+3", "1.0e15", "3.14159",
    ".inf", "-.inf", "+.INF", ".NaN", "1:30.5",
    # ... and what is not one
    "1e-15", "1e3", "1.5e3x", "0o17",
    # integers
    "0", "-0", "+12", "64", "1_000", "0x1F", "-0x_a", "0b101", "017", "08", "1:30", "190:20:30",
    # booleans and nulls
    "yes", "No", "ON", "off", "TRUE", "false", "tRue", "y", "n", "~", "null", "NULL", "Null", "",
    "nil", "none", "None",
    # strings
    "???", "LAST", "'quoted: yes'", '"dq \\t \\u00e9 \\\\ \\""', "'it''s'", "a b c", "a#b",
    "a # comment", "/tmp/a b/frames", "C:/x", "http://x.y", "-5", "-a", "random:3",
    # flow collections
    "[8,8,8,4]", "[64, 64, 64, 25]", "[1, 2.5, yes, null, 'x', [a, b]]", "[]", "{}", "[a, b, ]",
    "{a: 1, b: [2, 3], 'c d': ~}", "{a, b: }", "[-10, 80]", "[200, 500., 5000., 1000]",
    # documents
    "x: 1", "a:\n  - 1\n  - 2\nb:\n- x: 1\n  y: [1,\n   2]\n- - 3\n  - 4\n-\n  z: 5\n",
    "a:\n  b:\n    c: d\n  e: 'f'  # c\n", "- a\n- b: c\n  d: e\n", "k: -1.e-3\nl: 1e3\n",
    "'a': 1\n\"b\": 2\n3: 4\n", "a:\nb: 1\n", "# only a comment\n", "a: 1\na: 2\n",
]


@pytest.mark.parametrize("text", CORPUS)
def test_scalars_and_documents_parse_as_pyyaml(text):
    assert same(yaml_lite.safe_load(text), yaml.safe_load(text))


TRICKY = {
    "floats": [1e-15, 5000.0, 1.5e-07, 2e20, -0.0, float("inf"), float("-inf"), float("nan"), 0.1],
    "ints": [0, -3, 10 ** 20],
    "strings": ["yes", "no", "null", "~", "", "???", "1e-15", "1.0", "0x10", "a: b", "a #b", " pad ",
                "x\ny", "é", "[1, 2]", "- a", "2001-12-14", "LAST", "True"],
    "nested": {"empty_list": [], "empty_map": {}, "list_of_maps": [{"a": 1}, {"b": [1, 2]}],
               "lists": [[1, 2], [], ["a"]]},
    "none": None, "bool": False,
}


@pytest.mark.parametrize("name", ["tricky", "stable-zero123", "sugar_dynamic_dg",
                                  "sugar_static_refine"])
def test_writer_round_trips_through_both_readers(name):
    if name == "tricky":
        data = TRICKY
    else:
        with open(os.path.join(REPO, "configs", f"{name}.yaml")) as f:
            data = yaml.safe_load(f)
    text = yaml_lite.safe_dump(data)
    assert same(yaml_lite.safe_load(text), data)
    assert same(yaml.safe_load(text), data)


@pytest.mark.parametrize("text", [
    "&a x", "a: &x 1", "a: *x", "a: !!str 1", "a: |\n  x\n", "a: >\n  x\n", "---\na: 1\n",
    "a: 1\n---\nb: 2\n", "%YAML 1.1\n", "? a\n: b\n", "a: b\n  c\n", "a: b: c", "2001-12-14",
    "a: [1, , 2]", "a:\n\tb: 1\n", "'unterminated", "[1, 2", "a: <<", "a: =", "[a: 1]",
])
def test_outside_the_subset_raises(text):
    with pytest.raises(yaml_lite.YAMLError):
        yaml_lite.safe_load(text)


def _dotlists(tmp):
    out = f"exp_root_dir={tmp}/out"
    return {
        "stable-zero123.yaml": [
            "system.guidance.pretrained_model_name_or_path=none", "data.image_path=/x/ball_rgba.png",
            "data.height=48", "data.width=48", "data.random_camera.height=32",
            "data.random_camera.width=32", "data.random_camera.batch_size=2",
            "system.geometry.pos_encoding_config.n_levels=6", "trainer.max_steps=25",
            out, "use_timestamp=false", "tag=nerf"],
        # run_recovery's static stage
        "sugar_static_refine.yaml": [
            "system.guidance.pretrained_model_name_or_path=none",
            "data.image_path=/f/frames/000_rgba.png", "data.height=64", "data.width=64",
            "data.random_camera.height=64", "data.random_camera.width=64",
            "data.random_camera.batch_size=2", "system.geometry.surface_mesh_to_bind_path=/f/rest.ply",
            "system.renderer.backend=xla", "system.renderer.tile_capacity=512",
            "trainer.max_steps=1000", "trainer.val_check_interval=10000", out,
            "use_timestamp=false", "tag=recov"],
        # test_launch_dynamic's dynamic stage, with run_recovery's weights
        "sugar_dynamic_dg.yaml": [
            "system.guidance.pretrained_model_name_or_path=none", "data.video_frames_dir=/f/frames",
            "data.height=32", "data.width=32", "data.num_frames=2", "data.random_camera.height=32",
            "data.random_camera.width=32", "data.random_camera.batch_size=2",
            "system.geometry.num_frames=8", "system.geometry.surface_mesh_to_bind_path=/f/mesh.ply",
            "system.geometry.n_dg_nodes=32", "system.geometry.dg_node_connectivity=4",
            "system.geometry.dist_mode=eucdisc",
            "system.geometry.deformation.base_resolution=[8,8,8,4]",
            "system.geometry.deformation.multires=[1,2]", "system.renderer.backend=xla",
            "system.renderer.tile_capacity=128", "trainer.max_steps=3",
            "trainer.val_check_interval=100", "system.weights=/o/ckpts/step_00001000", out,
            "use_timestamp=false", "tag=dyn"],
        # the zoo: prompts with spaces, an image path with a space, imagecondition's ??? prompt kept
        "zoo/zero123.yaml": ["data.image_path=/x/my ball_rgba.png", "system.guidance.pretrained_model_name_or_path=random:0",
                             out, "use_timestamp=false"],
        "zoo/dreamfusion-sd.yaml": ["system.prompt_processor.prompt=a DSLR photo of a corgi", out,
                                    "use_timestamp=false"],
        "zoo/magic3d-coarse-sd.yaml": ["system.prompt_processor.prompt=a hamburger", "trainer.max_steps=5",
                                       out, "use_timestamp=false"],
        "zoo/dreamfusion-sd-eff.yaml": ["system.prompt_processor.prompt=a  test object ",
                                        "system.loss.lambda_z_variance=0.1", out, "use_timestamp=false"],
        "zoo/magic123-coarse-sd.yaml": ["data.image_path=/x/cake_rgba.png", "system.prompt_processor.prompt=a cake",
                                        "system.guidance_3d.pretrained_model_name_or_path=random:0", out,
                                        "use_timestamp=false"],
        "zoo/imagecondition.yaml": ["data.image_path=/x/cake_rgba.png", out, "use_timestamp=false"],
    }


@pytest.mark.parametrize("name", ["stable-zero123.yaml", "sugar_static_refine.yaml",
                                  "sugar_dynamic_dg.yaml", "zoo/zero123.yaml", "zoo/dreamfusion-sd.yaml",
                                  "zoo/magic3d-coarse-sd.yaml", "zoo/dreamfusion-sd-eff.yaml",
                                  "zoo/magic123-coarse-sd.yaml", "zoo/imagecondition.yaml"])
def test_load_config_matches_jax(name, tmp_path):
    path = os.path.join(REPO, "configs", name)
    extras = _dotlists(tmp_path)[name]
    cfg = load_config(path, cli_args=extras, makedirs=False)
    jcfg = j_load_config(path, cli_args=extras, makedirs=False)
    got = config_to_primitive(dataclasses.asdict(cfg))
    want = j_config_to_primitive(dataclasses.asdict(jcfg))
    assert same(got, want)
    assert cfg.trial_dir == jcfg.trial_dir and not os.path.exists(cfg.trial_dir)
    # parsed.yaml, as the launcher writes it, reads back to the same config
    parsed = tmp_path / "parsed.yaml"
    dump_config(str(parsed), cfg)
    assert same(yaml.safe_load(parsed.read_text()), got)
    again = config_to_primitive(dataclasses.asdict(load_config(str(parsed), makedirs=False)))
    assert same(again, got)


def test_dynamic_tag_and_resolvers(tmp_path):
    cfg = load_config(os.path.join(REPO, "configs", "sugar_dynamic_dg.yaml"), makedirs=False, cli_args=[
        "data.video_frames_dir=/data/my frames", "use_timestamp=false", f"exp_root_dir={tmp_path}",
        "system.loss.lambda_normal=[0, 0.0, 1.0, 10]"])
    assert cfg.tag == "512_my_frames_deformation"
    assert cfg.data.requires_normal is True and cfg.data.requires_depth is False
    assert cfg.system.loss.lambda_mask == [200, 500.0, 5000.0, 1000]
    assert cfg.system.optimizer.args.eps == 1e-15 and cfg.system.geometry.num_frames == 32


def test_registry_resolves_the_stages_names():
    from dreammesh4d_tpu_torch.data.image import SingleImageDataModule
    from dreammesh4d_tpu_torch.data.temporal_image import TemporalImageDataModule
    from dreammesh4d_tpu_torch.systems.assembly import (Sugar4DGenExperiment, SugarStaticExperiment,
                                                        Zero123Experiment)
    from dreammesh4d_tpu_torch.systems.assembly_zoo import ZooVSDExperiment
    from dreammesh4d_tpu_torch.systems.threestudio_zoo2 import ConfigSystem

    assert registry.find("sugar-static-system") is SugarStaticExperiment
    assert registry.find("sugar-4dgen-system") is Sugar4DGenExperiment
    assert registry.find("single-image-datamodule") is SingleImageDataModule
    assert registry.find("temporal-image-datamodule") is TemporalImageDataModule
    mixed = registry.find("sugar-static-system:single-image-datamodule")
    assert issubclass(mixed, SugarStaticExperiment) and issubclass(mixed, SingleImageDataModule)
    assert registry.find("zero123-system") is Zero123Experiment
    assert registry.find("prolificdreamer-system") is ZooVSDExperiment
    assert registry.find("fantasia3d-system") is ConfigSystem
    from dreammesh4d_tpu_torch.systems.editing import Control4DSystem

    assert registry.find("control4d-system") is Control4DSystem
    with pytest.raises(KeyError):
        registry.find("co3d-datamodule")  # not ported yet (ROADMAP A8.7)


def test_random_text_parses_as_pyyaml_or_raises():
    """On 20,000 seeded random strings over YAML's indicators the reader
    gives PyYAML's value or raises ``YAMLError``: it never reads text
    differently, nor accepts what PyYAML refuses."""
    import random
    import string

    rng = random.Random(0)
    alphabet = string.ascii_letters[:6] + string.digits[:4] + " :-[]{},#'\"._~!&*|>?@`%\n=<+/\\"
    for _ in range(20000):
        text = "".join(rng.choice(alphabet) for _ in range(rng.randint(0, 12)))
        try:
            got = yaml_lite.safe_load(text)
        except yaml_lite.YAMLError:
            continue
        want = yaml.safe_load(text)  # raises if the reader accepted what PyYAML refuses
        assert same(got, want), (text, got, want)
