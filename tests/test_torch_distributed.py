"""PyTorch port vs the JAX reference: the distributed slice, on gloo ranks
on the CPU.

One JAX subprocess with 4 placeholder host devices
(``--xla_force_host_platform_device_count=4``) writes the reference's
results to an npz, with the float params both packages start from.  The
port runs three launches of ranks (``repro_torch.launch.mesh.spawn``, a
file store under ``tmp_path``, one torch thread a rank):

A. 4 ranks:
   (1) the train step on a (2, 2) mesh, qwen3-8b ``--smoke`` at d 64,
       ffn 128, 2 layers, batch 8 × seq 16: loss |Δ| < 1e-3 and the first
       param leaf (the embedding table) within atol 5e-3 (the reference's
       own bounds), against the port's unsharded step and JAX's sharded
       step;
   (2) the same under ``FSDP_RULES``: ``w_up`` carries both axes; and a
       bfloat16 variant whose vocab (98) divides the model axis (the
       vocab-parallel embedding, the row-sharded products reduced in
       float32) against the port's unsharded step; the ``--smoke`` SSM,
       MoE and hybrid configs likewise (loss and grad norm);
   (3) GPipe, 4 stages, M 8, mb 4, D 16: output and weight gradient within
       1e-5 of the sequential composition, the output within 1e-5 of JAX's;
   (4) the compressed all-reduce on 4 ranks, two rounds: codes, mean and
       error EQUAL to JAX's, the mean within 5 % of the true mean;
   (5) a LUT-frozen ``--smoke`` qwen3-8b sharded over the model axis: each
       rank's ``wq`` / ``w_scale`` / ``luts`` N/2 wide, logits within 1e-4
       of the unsharded port and of JAX's sharded forward, argmax equal;
   (2b) the ``--smoke`` MoE config with the sort-based dispatch
       (``moe_impl="sorted"``), and qwen3-8b with one KV head, on (2, 2)
       against one device, at the dense dispatch's bound;
   (8) a prefill and three decode steps through dense caches placed on a
       (2, 2) mesh, one KV head (neither it nor its flat projection's
       split divides the model axis, so the caches fall back to their
       sequence axis; a prefill row crosses the ranks' blocks): logits
       within 1e-4 and caches within 1e-5 of the unsharded port;
   (7a) the launcher's rank body at ``--mesh 2x2``, with one microbatch
       and with two: losses within 1e-3 of ``--mesh 1x1``.
B. 2 ranks: (6) a tensor-parallel ``PagedScheduler`` serve of the CI
   smoke's model (``examples/serve_da.py: build_cfg``) from a
   ``bitplane_stacked`` freeze, mesh (1, 2): tokens EQUAL to the unsharded
   port's, each rank's pools holding one of the two KV heads.
C. ``python -m repro_torch.launch.train --mesh 2x2 --fake-devices 4
   --device cpu`` (7b): resumes a 1×1 checkpoint, and its checkpoint
   resumes on 1×1, each step's loss within 1e-3 of an uninterrupted 1×1
   run.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL, PARAM_ATOL = 1e-3, 5e-3   # the reference's test_distributed bounds
PIPE_TOL, LOGIT_TOL = 1e-5, 1e-4
S, M, MB, D = 4, 8, 4, 16           # GPipe: stages, microbatches, rows, width

JAX_SCRIPT = """
import dataclasses, json, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.checkpoint.ckpt import save_tree
from repro.configs.registry import ARCHS, reduce_for_smoke
from repro.core.da import DAConfig
from repro.core.freeze import freeze_model
from repro.data.pipeline import DataConfig, batch_at
from repro.launch import specs as SP
from repro.launch.mesh import make_test_mesh, shard_map_compat
from repro.launch.sharding import FSDP_RULES, LM_RULES, shard_frozen_params, use_mesh_rules
from repro.models.model import forward, init_model
from repro.optim.compress import allreduce_compressed
from repro.train.pipeline import make_pipelined_apply
from repro.train.trainer import TrainConfig, init_state, make_train_step

out_dir = sys.argv[1]
out = {}
to_ns = lambda mesh, t: jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                                     is_leaf=lambda x: isinstance(x, P))
# (1) + (2): the sharded train step
cfg = dataclasses.replace(reduce_for_smoke(ARCHS["qwen3-8b"]), d_model=64,
                          d_ff=128, n_layers=2)
dc = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=8, seed=0)
batch = jax.tree.map(jnp.asarray, batch_at(dc, 0))
state = init_state(jax.random.key(0), cfg)
save_tree(out_dir + "/train_params", state.params)
step = make_train_step(cfg, TrainConfig())
mesh = make_test_mesh((2, 2), ("data", "model"))
for kind, rules in (("lm", LM_RULES), ("fsdp", FSDP_RULES)):
    with use_mesh_rules(mesh, rules):
        sspec, bspec = SP.tree_pspecs(state), SP.batch_pspecs(batch)
        st = jax.device_put(state, to_ns(mesh, sspec))
        bt = jax.device_put(batch, to_ns(mesh, bspec))
        s_sh, m_sh = jax.jit(step, in_shardings=(to_ns(mesh, sspec), to_ns(mesh, bspec)),
                             out_shardings=(to_ns(mesh, sspec), None))(st, bt)
    out[kind + "_loss"] = np.float32(m_sh["loss"])
    out[kind + "_table"] = np.asarray(s_sh.params["embed"]["table"])
    out[kind + "_w_up_spec"] = np.array(json.dumps(
        [a for a in sspec.params["periods"]["pos_0"]["ffn"]["w_up"]]))
# (3) GPipe
rng = np.random.default_rng(0)
ws = (rng.standard_normal((%(S)d, %(D)d, %(D)d)) * 0.3).astype(np.float32)
x = rng.standard_normal((%(M)d * %(MB)d, %(D)d)).astype(np.float32)
pmesh = make_test_mesh((%(S)d,), ("stage",))
apply = make_pipelined_apply(pmesh, "stage", lambda w, h: jnp.tanh(h @ w), %(M)d)
out["pipe_ws"], out["pipe_x"] = ws, x
out["pipe_y"] = np.asarray(apply(jax.device_put(jnp.asarray(ws), NamedSharding(pmesh, P("stage"))),
                                 jnp.asarray(x)))
# (4) the compressed all-reduce, two rounds of error feedback
dmesh = make_test_mesh((4,), ("data",))
def f(g_local, err):
    mean, new_err = allreduce_compressed({"w": g_local}, err, "data")
    return mean["w"], new_err["w"]
f_sh = shard_map_compat(f, mesh=dmesh, in_specs=(P("data"), {"w": P("data")}),
                        out_specs=(P(), P("data")), check=False)
g1 = rng.standard_normal((4, 64)).astype(np.float32)
g2 = (rng.standard_normal((4, 64)) * 3).astype(np.float32)
err = jnp.zeros((4, 64), jnp.float32)
out["ar_g1"], out["ar_g2"] = g1, g2
for i, g in ((1, g1), (2, g2)):
    mean, err = f_sh(jnp.asarray(g), {"w": err})
    out[f"ar_mean{i}"], out[f"ar_err{i}"] = np.asarray(mean), np.asarray(err)
# (5) a LUT-frozen model sharded over the model axis
fcfg = dataclasses.replace(reduce_for_smoke(ARCHS["qwen3-8b"]), moe_dropless=True)
params = init_model(jax.random.key(0), fcfg)
save_tree(out_dir + "/frozen_params", params)
art = freeze_model(params, DAConfig(x_signed=True), mode="lut")
toks = np.asarray(jax.random.randint(jax.random.key(1), (4, 8), 0, fcfg.vocab), np.int32)
out["lut_toks"] = toks
with use_mesh_rules(mesh):
    sharded = shard_frozen_params(art.params)
    out["lut_logits"] = np.asarray(jax.jit(lambda p, t: forward(p, t, fcfg)[0])(sharded, toks))
np.savez(out_dir + "/ref.npz", **out)
print("OK")
""" % dict(S=S, D=D, M=M, MB=MB)


@pytest.fixture(scope="module")
def ref_dir(tmp_path_factory):
    """The reference's results, from one JAX process with 4 host devices."""
    d = tmp_path_factory.mktemp("jax_ref")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(JAX_SCRIPT), str(d)],
                         capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0 and "OK" in out.stdout, out.stderr[-4000:]
    return str(d)


@pytest.fixture(scope="module")
def ref(ref_dir):
    with np.load(os.path.join(ref_dir, "ref.npz")) as z:
        return {k: z[k] for k in z.files}


# ---------------------------------------------------------------------------
# workers (module level: the spawned ranks import them)
# ---------------------------------------------------------------------------
def _train_cfg():
    from repro_torch.configs.registry import ARCHS, reduce_for_smoke

    return dataclasses.replace(reduce_for_smoke(ARCHS["qwen3-8b"]), d_model=64,
                               d_ff=128, n_layers=2)


def _load_params(path):
    from repro_torch.checkpoint.ckpt import load_tree
    from repro_torch.convert import params_from_jax

    return params_from_jax(load_tree(path), device="cpu")


def _train_step_vocab_sharded():
    """A bfloat16 model whose vocab (98) divides the model axis: the table
    and the LM head shard on the vocab, the row-sharded products reduce in
    float32.  The port's sharded step against its unsharded one."""
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import specs as SP
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.model import init_model
    from repro_torch.train.trainer import TrainConfig, make_train_step, state_from_params
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(_train_cfg(), vocab=98, param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    dc = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=8, seed=0)
    batch = {k: torch.as_tensor(v) for k, v in batch_at(dc, 0).items()}
    params = init_model(cfg, seed=0, device="cpu")
    step = make_train_step(cfg, TrainConfig())
    s_ref, m_ref = step(state_from_params(tree_map(torch.clone, params)), batch)
    mesh = make_test_mesh((2, 2), ("data", "model"))
    with shd.use_mesh_rules(mesh):
        params = SP.place(params, SP.tree_pspecs(params), mesh)
        table_spec = shd.spec_of(params["embed"]["table"])
        s_sh, m_sh = step(state_from_params(params),
                          SP.place(batch, SP.batch_pspecs(batch), mesh))
    return {"loss": float(shd.full(m_sh["loss"])), "loss_1": float(m_ref["loss"]),
            "table": shd.full(s_sh.params["embed"]["table"]).float().numpy(),
            "table_1": s_ref.params["embed"]["table"].float().numpy(),
            "table_spec": tuple(table_spec)}


FAMILIES = ("mamba2-780m", "qwen2-moe-a2.7b", "jamba-1.5-large-398b")
#: configs again with a lever: the MoE with the sort-based dispatch, and
#: qwen3 with one KV head (its K/V projections' split does not divide the
#: model axis: each rank's q heads read the one KV head, its gradient a
#: partial sum)
LEVERS = {"qwen2-moe-a2.7b:sorted": ("qwen2-moe-a2.7b", {"moe_impl": "sorted"}),
          "qwen3-8b:kv1": ("qwen3-8b", {"n_kv_heads": 1})}


def _train_step_families():
    """The ``--smoke`` SSM, MoE and hybrid configs (vocab 98, so the table
    shards too) on a (2, 2) mesh: loss and grad norm against the port's
    unsharded step (the replicate sites of the SSD scan, the conv and the
    MoE dispatch; the experts applied on their own ranks)."""
    from repro_torch.configs.registry import ARCHS, reduce_for_smoke
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import specs as SP
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.model import init_model
    from repro_torch.train.trainer import TrainConfig, make_train_step, state_from_params
    from repro_torch.tree import tree_map

    mesh = make_test_mesh((2, 2), ("data", "model"))
    out = {}
    for arch in FAMILIES + tuple(LEVERS):
        name, levers = LEVERS.get(arch, (arch, {}))
        cfg = dataclasses.replace(reduce_for_smoke(ARCHS[name]), vocab=98, **levers)
        dc = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=8, seed=0)
        batch = {k: torch.as_tensor(v) for k, v in batch_at(dc, 0).items()}
        params = init_model(cfg, seed=0, device="cpu")
        step = make_train_step(cfg, TrainConfig())
        _, m_ref = step(state_from_params(tree_map(torch.clone, params)), batch)
        with shd.use_mesh_rules(mesh):
            params = SP.place(params, SP.tree_pspecs(params), mesh)
            _, m_sh = step(state_from_params(params),
                           SP.place(batch, SP.batch_pspecs(batch), mesh))
        out[arch] = {k: (float(shd.full(m_sh[k])), float(m_ref[k]))
                     for k in ("loss", "grad_norm")}
    return out


def _dense_cache_on_a_mesh():
    """(8): the prefill and decode steps of the slot runtime's dense caches
    on a (2, 2) mesh (``launch/specs.py: place_caches``) against one
    device."""
    from repro_torch.configs.registry import ARCHS, reduce_for_smoke
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import specs as SP
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.model import init_caches, init_model
    from repro_torch.serve.engine import make_prefill_step, make_serve_step

    cfg = dataclasses.replace(reduce_for_smoke(ARCHS["qwen3-8b"]), n_kv_heads=1,
                              vocab=98)
    params = init_model(cfg, seed=0, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(3).integers(0, 98, (2, 17)))
    prefill, decode = make_prefill_step(cfg), make_serve_step(cfg)

    def run(params, caches, place):
        pos = torch.arange(14, dtype=torch.int32)[None].expand(2, 14)
        out, caches = prefill(params, caches, place(toks[:, :14]), place(pos))
        logits = [shd.full(out)]
        for i in range(14, 17):
            p = torch.full((2, 1), i, dtype=torch.int32)
            out, caches = decode(params, caches, place(toks[:, i:i + 1]), place(p))
            logits.append(shd.full(out))
        return torch.stack(logits), caches

    with torch.no_grad():
        one, one_c = run(params, init_caches(cfg, 2, 24, device="cpu"), lambda t: t)
        mesh = make_test_mesh((2, 2), ("data", "model"))
        with shd.use_mesh_rules(mesh):
            caches = init_caches(cfg, 2, 24, device="cpu")
            caches = SP.place_caches(caches, SP.cache_pspecs(caches), mesh)
            rows = lambda t: shd.distribute(t, shd.NamedSharding(  # noqa: E731
                mesh, shd.pspec(("batch", None), t.shape)))
            sharded, sh_c = run(SP.place(params, SP.tree_pspecs(params), mesh),
                                caches, rows)
    k = sh_c["pos_0"].k
    return {"logits": sharded.numpy(), "logits_1": one.numpy(),
            "k": k.full_tensor().numpy(), "k_1": one_c["pos_0"].k.numpy(),
            "k_local": tuple(k.to_local().shape),
            "length": int(shd.full(sh_c["pos_0"].length)[0])}


def _train_step(ref_dir, rules):
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import specs as SP
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.train.trainer import TrainConfig, make_train_step, state_from_params

    cfg = _train_cfg()
    dc = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=8, seed=0)
    batch = {k: torch.as_tensor(v) for k, v in batch_at(dc, 0).items()}
    step = make_train_step(cfg, TrainConfig())
    s_ref, m_ref = step(state_from_params(_load_params(ref_dir + "/train_params")),
                        batch)
    mesh = make_test_mesh((2, 2), ("data", "model"))
    state = state_from_params(_load_params(ref_dir + "/train_params"))
    with shd.use_mesh_rules(mesh, rules):
        sspec = SP.tree_pspecs(state)
        st = SP.place(state, sspec, mesh)
        bt = SP.place(batch, SP.batch_pspecs(batch), mesh)
        s_sh, m_sh = step(st, bt)
    return {"loss": float(shd.full(m_sh["loss"])), "loss_1": float(m_ref["loss"]),
            "table": shd.full(s_sh.params["embed"]["table"]).numpy(),
            "table_1": s_ref.params["embed"]["table"].numpy(),
            "w_up_spec": tuple(sspec.params["blocks"][0]["ffn"]["w_up"]),
            "w_up_local": tuple(st.params["blocks"][0]["ffn"]["w_up"].to_local().shape)}


def _gpipe(ws, x):
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.sharding import NamedSharding, P, distribute
    from repro_torch.train.pipeline import make_pipelined_apply

    mesh = make_test_mesh((S,), ("stage",))
    stage_fn = lambda w, h: torch.tanh(h @ w)  # noqa: E731
    apply = make_pipelined_apply(mesh, "stage", stage_fn, n_microbatches=M)
    sw = distribute(torch.from_numpy(ws), NamedSharding(mesh, P("stage")))
    sw.requires_grad_(True)
    xt = torch.from_numpy(x)
    y = apply(sw, xt).to_local()
    g, = torch.autograd.grad((y * y).sum(), [sw])
    seq_w = torch.from_numpy(ws).requires_grad_(True)
    r = xt
    for s in range(S):
        r = stage_fn(seq_w[s], r)
    g_seq, = torch.autograd.grad((r * r).sum(), [seq_w])
    return {"y": y.detach().numpy(), "y_seq": r.detach().numpy(),
            "g": g.full_tensor().numpy(), "g_seq": g_seq.numpy()}


def _allreduce(g1, g2):
    from repro_torch.launch.mesh import make_test_mesh, shard_map_compat
    from repro_torch.launch.sharding import P
    from repro_torch.optim.compress import allreduce_compressed, compress_with_ef

    mesh = make_test_mesh((4,), ("data",))

    def f(g_local, err):
        mean, new_err = allreduce_compressed({"w": g_local}, err, "data")
        return mean["w"], new_err["w"]

    f_sh = shard_map_compat(f, mesh=mesh, in_specs=(P("data"), {"w": P("data")}),
                            out_specs=(P(), P("data")))
    out, err = {}, torch.zeros(4, 64)
    for i, g in ((1, g1), (2, g2)):
        mean, err_dt = f_sh(torch.from_numpy(g), {"w": err})
        err = err_dt.full_tensor()
        out[f"mean{i}"], out[f"err{i}"] = mean.to_local().numpy(), err.numpy()
    codes, _ = compress_with_ef({"w": torch.from_numpy(g1)}, {"w": torch.zeros(4, 64)})
    out["codes"] = codes["w"][0].numpy()
    return out


def _lut_forward(ref_dir, toks):
    from repro_torch.core.da import DAConfig
    from repro_torch.core.freeze import freeze_model
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.model import forward
    from repro_torch.configs.registry import ARCHS, reduce_for_smoke

    cfg = dataclasses.replace(reduce_for_smoke(ARCHS["qwen3-8b"]), moe_dropless=True)
    art = freeze_model(_load_params(ref_dir + "/frozen_params"),
                       DAConfig(x_signed=True), mode="lut", device="cpu")
    toks = torch.from_numpy(toks)
    with torch.no_grad():
        logits_1, _ = forward(art.params, toks, cfg)
        mesh = make_test_mesh((2, 2), ("data", "model"))
        with shd.use_mesh_rules(mesh):
            sharded = shd.shard_frozen_params(art.params)
            logits, _ = forward(sharded, toks, cfg)
    pw = sharded["blocks"][0]["mixer"]["wq"]
    return {"logits": shd.full(logits).numpy(), "logits_1": logits_1.numpy(),
            "local": [tuple(t.to_local().shape) for t in (pw.wq, pw.w_scale, pw.luts)],
            "global": [tuple(t.shape) for t in (pw.wq, pw.w_scale, pw.luts)]}


LAUNCH_ARGS = ["--arch", "qwen3-8b", "--smoke", "--batch", "8", "--seq", "16",
               "--device", "cpu"]


def _launcher_rank(extra=()):
    from repro_torch.launch import train

    _, hist = train._rank_main(LAUNCH_ARGS + ["--steps", "3", "--mesh", "2x2",
                                              *extra])
    return [h["loss"] for h in hist]


def _four_ranks(ref_dir, ref):
    from repro_torch.launch.sharding import FSDP_RULES, LM_RULES

    out = {"lm": _train_step(ref_dir, LM_RULES),
           "fsdp": _train_step(ref_dir, FSDP_RULES),
           "vocab": _train_step_vocab_sharded(),
           "families": _train_step_families(),
           "dense_cache": _dense_cache_on_a_mesh(),
           "gpipe": _gpipe(ref["pipe_ws"], ref["pipe_x"]),
           "allreduce": _allreduce(ref["ar_g1"], ref["ar_g2"]),
           "lut": _lut_forward(ref_dir, ref["lut_toks"]),
           "launcher": _launcher_rank(),
           "launcher_mb": _launcher_rank(["--microbatches", "2"])}
    return out


def _tp_serve(mode):
    from repro_torch.core.da import DAConfig
    from repro_torch.core.freeze import freeze_model
    from repro_torch.examples.serve_da import build_cfg
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.model import init_model
    from repro_torch.serve.scheduler import PagedScheduler, Request

    cfg = build_cfg()
    art = freeze_model(init_model(cfg, seed=0, device="cpu"),
                       DAConfig(x_signed=True), mode=mode, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
               for n in (5, 9, 12, 7)]

    def serve(params):
        s = PagedScheduler(cfg, params, batch_size=2, max_len=64, device="cpu")
        for i, p in enumerate(prompts):
            s.submit(Request(uid=i, prompt=p, max_new_tokens=8))
        done = s.run()
        return {u: list(r.generated) for u, r in done.items()}, s

    plain, _ = serve(art.params)
    mesh = make_test_mesh((1, 2), ("data", "model"))
    with shd.use_mesh_rules(mesh):
        tp, sched = serve(shd.shard_frozen_params(art.params))
    pool = sched.caches["pos_0"].k
    return {"plain": plain, "tp": tp, "pool_local": tuple(pool.to_local().shape),
            "pool": tuple(pool.shape)}


# ---------------------------------------------------------------------------
# launch A: four ranks
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def four(ref_dir, ref, tmp_path_factory):
    from repro_torch.launch.mesh import spawn

    torch.set_num_threads(1)
    out = spawn(_four_ranks, 4, (ref_dir, ref),
                init_dir=str(tmp_path_factory.mktemp("store")))
    assert all(o is not None for o in out)
    return out


@pytest.mark.parametrize("kind", ["lm", "fsdp"])
def test_sharded_train_step_matches_one_device_and_jax(four, ref, kind):
    for rank in four:
        got = rank[kind]
        assert abs(got["loss"] - got["loss_1"]) < LOSS_TOL
        assert abs(got["loss"] - float(ref[kind + "_loss"])) < LOSS_TOL
        np.testing.assert_allclose(got["table"], got["table_1"], atol=PARAM_ATOL)
        np.testing.assert_allclose(got["table"], ref[kind + "_table"], atol=PARAM_ATOL)


def test_vocab_sharded_bf16_train_step_matches_one_device(four):
    for rank in four:
        got = rank["vocab"]
        assert got["table_spec"] == ("model",)
        assert abs(got["loss"] - got["loss_1"]) < LOSS_TOL
        np.testing.assert_allclose(got["table"], got["table_1"], atol=PARAM_ATOL)


@pytest.mark.parametrize("arch", FAMILIES + tuple(LEVERS))
def test_family_train_step_on_a_mesh_matches_one_device(four, arch):
    for rank in four:
        for key, (sharded, one) in rank["families"][arch].items():
            assert abs(sharded - one) < LOSS_TOL * max(1.0, abs(one)), (key, sharded, one)


def test_dense_caches_on_a_mesh_match_one_device(four):
    for rank in four:
        got = rank["dense_cache"]
        assert got["k_local"] == (2, 1, 12, 1, 16)   # [P, B/2, S/2, kv, hd]
        assert got["length"] == 17
        np.testing.assert_allclose(got["logits"], got["logits_1"], atol=LOGIT_TOL)
        np.testing.assert_allclose(got["k"], got["k_1"], atol=1e-5)


def test_fsdp_rules_shard_w_up_over_both_axes(four, ref):
    import json

    spec = four[0]["fsdp"]["w_up_spec"]
    assert spec == ("data", "model")
    assert json.loads(str(ref["fsdp_w_up_spec"]))[1:] == list(spec)
    assert four[0]["fsdp"]["w_up_local"] == (32, 64)   # [64, 128] over 2 × 2
    assert four[0]["lm"]["w_up_local"] == (64, 64)     # ffn over model only


def test_gpipe_matches_sequential_and_jax(four, ref):
    for rank in four:
        got = rank["gpipe"]
        np.testing.assert_allclose(got["y"], got["y_seq"], atol=PIPE_TOL)
        np.testing.assert_allclose(got["g"], got["g_seq"], atol=PIPE_TOL,
                                   rtol=PIPE_TOL)
        np.testing.assert_allclose(got["y"], ref["pipe_y"], atol=PIPE_TOL)


def test_compressed_allreduce_equals_jax(four, ref):
    import jax.numpy as jnp

    from repro.optim.compress import compress_with_ef as jcompress

    for rank in four:
        got = rank["allreduce"]
        for i in (1, 2):
            np.testing.assert_array_equal(got[f"mean{i}"], ref[f"ar_mean{i}"])
            np.testing.assert_array_equal(got[f"err{i}"], ref[f"ar_err{i}"])
        jc, _ = jcompress({"w": jnp.asarray(ref["ar_g1"])},
                          {"w": jnp.zeros((4, 64), jnp.float32)})
        np.testing.assert_array_equal(got["codes"], np.asarray(jc["w"][0]))
        true = ref["ar_g1"].mean(axis=0)
        rel = np.abs(got["mean1"][0] - true).max() / np.abs(true).max()
        assert rel < 0.05, rel


def test_lut_frozen_forward_sharded_over_the_model_axis(four, ref):
    for rank in four:
        got = rank["lut"]
        for local, full in zip(got["local"], got["global"]):
            assert local[:-1] == full[:-1] and local[-1] * 2 == full[-1]
        np.testing.assert_allclose(got["logits"], got["logits_1"], atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)
        np.testing.assert_allclose(got["logits"], ref["lut_logits"],
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
        assert (got["logits"].argmax(-1) == ref["lut_logits"].argmax(-1)).all()
        assert (got["logits"].argmax(-1) == got["logits_1"].argmax(-1)).all()


def _one_device_losses(steps, tmp, ckpt=None, every=2, extra=()):
    from repro_torch.launch import train

    args = LAUNCH_ARGS + ["--steps", str(steps), *extra]
    if ckpt:
        args += ["--ckpt-dir", ckpt, "--ckpt-every", str(every)]
    _, hist = train.main(args)
    return {h["step"]: h["loss"] for h in hist}


def test_launcher_rank_body_2x2_matches_1x1(four, tmp_path):
    one = _one_device_losses(3, tmp_path)
    for rank in four:
        assert len(rank["launcher"]) == 3
        for i, loss in enumerate(rank["launcher"]):
            assert abs(loss - one[i]) < LOSS_TOL


def test_launcher_microbatches_2x2_matches_1x1(four, tmp_path):
    """Two microbatches a step: the float32 accumulators are placed as the
    params, so each sharded gradient adds into its own slice."""
    one = _one_device_losses(3, tmp_path, extra=["--microbatches", "2"])
    for rank in four:
        assert len(rank["launcher_mb"]) == 3
        for i, loss in enumerate(rank["launcher_mb"]):
            assert abs(loss - one[i]) < LOSS_TOL


# ---------------------------------------------------------------------------
# launch B: a tensor-parallel serve on two ranks
# ---------------------------------------------------------------------------
def test_tensor_parallel_paged_serve_tokens_equal(tmp_path):
    from repro_torch.launch.mesh import spawn

    torch.set_num_threads(1)
    out = spawn(_tp_serve, 2, ("bitplane_stacked",), init_dir=str(tmp_path))
    for rank in out:
        assert rank["tp"] == rank["plain"]
        assert all(len(t) == 8 for t in rank["tp"].values())
        assert rank["pool_local"][-2] * 2 == rank["pool"][-2]
    assert out[0]["tp"] == out[1]["tp"]


# ---------------------------------------------------------------------------
# launch C: the launcher's --fake-devices, resuming across meshes
# ---------------------------------------------------------------------------
def test_launcher_fake_devices_resumes_across_meshes(tmp_path, capsys):
    from repro_torch.launch import train

    one = _one_device_losses(5, tmp_path)
    d = str(tmp_path / "ck")
    first = _one_device_losses(2, tmp_path, ckpt=d)          # 1x1 writes step 2
    lines, hist = train.main(LAUNCH_ARGS + [
        "--steps", "4", "--mesh", "2x2", "--fake-devices", "4",
        "--ckpt-dir", d, "--ckpt-every", "2"])                # 2x2 resumes, writes 4
    out = capsys.readouterr().out
    assert lines[0].startswith("arch=qwen3-8b") and "devices=4" in lines[0]
    assert lines[-1] == "done at step 4" and "done at step 4" in out
    assert [h["step"] for h in hist] == [2, 3]
    back = _one_device_losses(5, tmp_path, ckpt=d)            # 1x1 resumes at 4
    assert list(back) == [4]
    for losses in (first, {h["step"]: h["loss"] for h in hist}, back):
        for step, loss in losses.items():
            assert abs(loss - one[step]) < LOSS_TOL, (step, loss, one[step])
