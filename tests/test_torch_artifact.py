"""PyTorch port vs the JAX reference: DA artifacts on disk, both ways.

A JAX-written artifact boots in the port (``device="cpu"``) and decodes the
JAX engine's greedy tokens; an artifact the port writes boots in the JAX
package and decodes the port's tokens.  Every LUT backend yields the same
int32 accumulators, so where the JAX side would run a ``pallas_lut``
artifact through the Pallas kernel in interpret mode it serves the ``lut``
twin of the same weights instead (same tokens, a fraction of the time).
Inputs are made from seeds with numpy and ``jax.random``, on a 2-layer
qwen3 config.
"""
import dataclasses
import json
import os
import subprocess
import sys
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs.registry import ARCHS, reduce_for_smoke
from repro.core import freeze as jfreeze
from repro.core.engine import PackedWeights as JPacked
from repro.models.config import ModelConfig as JModelConfig
from repro.models.model import init_model as jinit
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.checkpoint import ckpt
from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_jax
from repro_torch.core import freeze as tfreeze
from repro_torch.core.da import DAConfig
from repro_torch.core.engine import PackedWeights, pack_weights
from repro_torch.models.config import ModelConfig
from repro_torch.serve.engine import Request, ServeEngine

MAX_NEW = 4
KW = dict(batch_size=2, max_len=32, page_size=8)


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(reduce_for_smoke(ARCHS["qwen3-8b"]),
                               moe_dropless=True)
    params = jinit(jax.random.key(0), jcfg)
    rng = np.random.default_rng(7)
    prompts = {u: rng.integers(0, jcfg.vocab, 3 + 6 * u).astype(np.int32)
               for u in range(3)}
    return jcfg, params, prompts


def _tokens(eng, prompts, request_cls):
    for uid, pr in prompts.items():
        eng.submit(request_cls(uid=uid, prompt=pr, max_new_tokens=MAX_NEW))
    done = eng.run()
    return {u: list(done[u].generated) for u in prompts}


def _jax_with_mode(params, mode):
    return jax.tree.map(
        lambda p: dataclasses.replace(p, mode=mode) if isinstance(p, JPacked) else p,
        params, is_leaf=lambda p: isinstance(p, JPacked))


def _jax_artifact(kind, jcfg, params, directory):
    """Freeze + save with the JAX package; returns the JAX engine's tokens
    source: an engine serving what was saved (or its lut twin)."""
    if kind == "auto":
        art = jfreeze.freeze_model(params, mode="auto", cost_table={},
                                   model_cfg=jcfg, group_size_candidates=(4, 8))
        assert {p.mode for p in art.plan.values()} == {"lut"}
        jfreeze.save_artifact(directory, art)
    elif kind == "pallas_lut":
        jfreeze.save_artifact(directory, jfreeze.freeze_model(
            params, mode="pallas_lut", model_cfg=jcfg))
        art = jfreeze.load_artifact(directory)
        return JServeEngine(art.model_cfg, _jax_with_mode(art.params, "lut"),
                            **KW)
    else:
        kv = "int8" if kind == "int8kv" else None
        JServeEngine(jcfg, params, da_mode="bitplane_stacked", kv_dtype=kv,
                     **KW).save_artifact(directory)
    return JServeEngine.from_artifact(directory, **KW)


@pytest.mark.parametrize("kind", ["bitplane_stacked", "auto", "pallas_lut",
                                  "int8kv"])
def test_jax_artifact_boots_in_port(model, kind, tmp_path):
    jcfg, params, prompts = model
    directory = str(tmp_path / "art")
    ref = _jax_artifact(kind, jcfg, params, directory)
    ours = ServeEngine.from_artifact(directory, device="cpu", **KW)
    plan = jfreeze.load_artifact(directory).plan
    assert {k: p.mode for k, p in ours.artifact.plan.items()} == \
        {k: p.mode for k, p in plan.items()}
    mixer = ours.params["blocks"][1]["mixer"]
    assert mixer["wq"].mode == plan["periods/pos_0/mixer/wq"].mode
    assert mixer["wq"].has_luts == plan["periods/pos_0/mixer/wq"].with_luts
    assert ours.cfg.kv_dtype == ("int8" if kind == "int8kv" else "fp16")
    assert _tokens(ours, prompts, Request) == _tokens(ref, prompts, JRequest)


@pytest.mark.parametrize("mode", ["pallas_lut", "pallas_bitplane"])
def test_port_artifact_boots_in_jax(model, mode, tmp_path):
    jcfg, params, prompts = model
    tcfg = treg.reduce_for_smoke(treg.get("qwen3-8b"))
    ours = ServeEngine(tcfg, params_from_jax(jax.tree.map(np.asarray, params)),
                       da_mode=mode, kv_dtype="int8", device="cpu", **KW)
    directory = ours.save_artifact(str(tmp_path / "art"))
    got = _tokens(ours, prompts, Request)
    art = jfreeze.load_artifact(directory)
    assert art.model_cfg.kv_dtype == "int8" and art.model_cfg.n_layers == 2
    assert art.plan["periods/pos_0/mixer/wk"].kv_dtype == "int8"
    assert art.params["periods"]["pos_0"]["mixer"]["wq"].wq.shape == (2, 64, 64)
    if mode == "pallas_lut":
        assert art.params["lm_head"]["w"].luts.shape == (8, 256, tcfg.vocab)
        ref = JServeEngine(art.model_cfg, _jax_with_mode(art.params, "lut"),
                           kv_dtype="int8", **KW)
    else:
        ref = JServeEngine.from_artifact(directory, **KW)
    assert _tokens(ref, prompts, JRequest) == got
    # the port reads its own artifact back exactly
    again = tfreeze.load_artifact(directory, device="cpu")
    for name in ("wq", "wk", "wv"):
        a = ours.params["blocks"][1]["mixer"][name]
        b = again.params["blocks"][1]["mixer"][name]
        assert torch.equal(a.wq, b.wq) and torch.equal(a.w_scale, b.w_scale)
        assert (a.luts is None) == (b.luts is None)
        assert a.luts is None or torch.equal(a.luts, b.luts)
    assert again.plan == ours.artifact.plan


def _small_tree():
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.normal(size=(12, 5)).astype(np.float32))
    return {"proj": {"w": pack_weights(w, DAConfig(group_size=4, x_signed=True),
                                       mode="lut")},
            "norm": {"scale": torch.arange(6, dtype=torch.float32).to(
                torch.bfloat16).reshape(2, 3)}}


def test_flipped_byte_raises_crc(tmp_path):
    directory = ckpt.save_tree(str(tmp_path / "t"), _small_tree())
    path = os.path.join(directory, "arrays.npz")
    with np.load(path) as data:
        arrays = {k: data[k].copy() for k in data.files}
    raw = arrays["proj/w/luts"].reshape(-1).view(np.uint8)
    raw[5] ^= 0x10
    np.savez(path, **arrays)
    with pytest.raises(IOError, match="checksum"):
        ckpt.load_tree(directory)


def test_bf16_leaf_round_trips_without_ml_dtypes(tmp_path):
    tree = _small_tree()
    directory = ckpt.save_tree(str(tmp_path / "t"), tree)
    with open(os.path.join(directory, "manifest.json")) as f:
        assert json.load(f)["arrays"]["norm/scale"]["dtype"] == "bfloat16"
    got = ckpt.load_tree(directory)
    assert torch.equal(got["norm"]["scale"], tree["norm"]["scale"])
    p, q = got["proj"]["w"], tree["proj"]["w"]
    assert isinstance(p, PackedWeights) and (p.cfg, p.mode) == (q.cfg, q.mode)
    assert torch.equal(p.luts, q.luts) and torch.equal(p.wq, q.wq)
    # the reference reads it too (through ml_dtypes)
    ref = jckpt.load_tree(directory)
    np.testing.assert_array_equal(np.asarray(ref["norm"]["scale"], np.float32),
                                  got["norm"]["scale"].float().numpy())
    # and the port reads it in a process where ml_dtypes cannot be imported
    code = ("import sys; sys.modules['ml_dtypes'] = None\n"
            "import torch\n"
            "from repro_torch.checkpoint import ckpt\n"
            f"t = ckpt.load_tree({directory!r})['norm']['scale']\n"
            "assert t.dtype == torch.bfloat16, t.dtype\n"
            "print(t.float().sum().item())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH="src"),
                         cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.returncode == 0, out.stderr
    assert float(out.stdout) == 15.0


def _edit_manifest(directory, fn):
    path = os.path.join(directory, "manifest.json")
    with open(path) as f:
        man = json.load(f)
    fn(man)
    with open(path, "w") as f:
        json.dump(man, f)


def test_stale_mode_demotes_to_auto_with_warning(model, tmp_path):
    jcfg, params, _ = model
    tcfg = treg.reduce_for_smoke(treg.get("qwen3-8b"))
    eng = ServeEngine(tcfg, params_from_jax(jax.tree.map(np.asarray, params)),
                      da_mode="bitplane", device="cpu", **KW)
    directory = eng.save_artifact(str(tmp_path / "art"))

    def stale(man):
        man["plan"]["periods/pos_0/ffn/w_up"]["mode"] = "retired_backend"
        man["packed"]["periods/pos_0/ffn/w_up"]["mode"] = "retired_backend"

    _edit_manifest(directory, stale)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        art = tfreeze.load_artifact(directory, device="cpu")
    assert any("retired_backend" in str(w.message) for w in caught)
    assert art.plan["periods/pos_0/ffn/w_up"].mode == "auto"
    assert art.plan["periods/pos_0/ffn/w_up"].source == "stale"
    assert all(b["ffn"]["w_up"].mode == "auto" for b in art.params["blocks"])
    assert art.params["blocks"][0]["ffn"]["w_down"].mode == "bitplane"


def test_from_artifact_kv_dtype_follows_the_plan(model, tmp_path):
    jcfg, params, _ = model
    directory = str(tmp_path / "art")
    JServeEngine(jcfg, params, da_mode="bitplane", kv_dtype="int8",
                 **KW).save_artifact(directory)
    assert ServeEngine.from_artifact(directory, device="cpu",
                                     **KW).cfg.kv_dtype == "int8"
    # an explicit dtype overrides a homogeneous plan
    assert ServeEngine.from_artifact(directory, kv_dtype="int4", device="cpu",
                                     **KW).cfg.kv_dtype == "int4"

    def per_layer(man):
        entry = dict(man["plan"]["periods/pos_0/mixer/wk"], kv_dtype="fp16")
        man["plan"]["periods/pos_1/mixer/wk"] = entry

    _edit_manifest(directory, per_layer)
    with pytest.raises(ValueError, match="flatten"):
        ServeEngine.from_artifact(directory, kv_dtype="int4", device="cpu", **KW)


def test_model_config_manifest_matches_reference():
    jcfg = dataclasses.replace(reduce_for_smoke(ARCHS["qwen3-8b"]),
                               moe_dropless=True, remat=False)
    ours = ModelConfig.from_manifest(json.loads(json.dumps(
        dataclasses.asdict(jcfg))))
    assert ours == dataclasses.replace(
        treg.reduce_for_smoke(treg.get("qwen3-8b")), moe_dropless=True)
    back = JModelConfig(**ours.to_manifest())
    for f in dataclasses.fields(ours):
        assert getattr(back, f.name) == getattr(ours, f.name)
    # the port's copy of the reference-only fields carries their defaults
    from repro_torch.models import config as tconfig

    ref_only = {f.name: f.default for f in dataclasses.fields(JModelConfig)
                if f.name not in {g.name for g in dataclasses.fields(ModelConfig)}}
    assert tconfig._REFERENCE_ONLY == ref_only
    with pytest.raises(NotImplementedError, match="tie_embeddings"):
        ModelConfig.from_manifest(dataclasses.asdict(
            dataclasses.replace(jcfg, tie_embeddings=True)))
    with pytest.raises(ValueError, match="neither"):
        ModelConfig.from_manifest(dict(dataclasses.asdict(jcfg), bogus=1))
