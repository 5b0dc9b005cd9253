"""PyTorch port vs the JAX reference: single-device training.

The same inputs, made from a seed with numpy, go through the reference's
data pipeline, schedule, AdamW, loss and gradient, train step, trainer and
step checkpoints, and through the port's:

* ``batch_at`` / ``host_shard`` / ``iterate`` and ``for_model`` are
  bit-equal (numpy in both);
* ``warmup_cosine`` within 4 float32 ulps (``SCHED_RTOL``: the two
  libraries' ``cos`` round differently);
* ``adamw.update`` within ``OPT_RTOL`` (float32 master, moments, params) and
  one bf16 ulp on bf16 params; the NaN guard leaves every entry as it was;
* ``loss_fn`` and every gradient leaf within ``GRAD_RTOL`` of
  ``jax.value_and_grad`` (relative to the leaf's largest magnitude) for a
  dense, an MoE and a Mamba-2 config in float32;
* three train steps at two microbatches: loss, ``grad_norm`` and ``lr``
  within ``GRAD_RTOL``, params within ``PARAM_ATOL``;
* step checkpoints restore across the packages, bf16 leaves bit-exact.

The tolerances are float32 reduction order: the two frameworks sum the same
terms in different orders.
"""
import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs.registry import ARCHS, reduce_for_smoke
from repro.data import pipeline as jpipe
from repro.optim import adamw as jadamw
from repro.optim.schedules import warmup_cosine as jwarmup
from repro.train import trainer as jtrainer
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_jax, params_to_ref, to_tensor
from repro_torch.data import pipeline as tpipe
from repro_torch.optim import adamw as tadamw
from repro_torch.optim.schedules import constant, warmup_cosine
from repro_torch.train import trainer as ttrainer
from repro_torch.tree import leaves, tree_map

SCHED_RTOL = 2 ** -21
OPT_RTOL = 1e-6
GRAD_RTOL = 2e-5
PARAM_ATOL = 1e-6
ARCH_NAMES = sorted(ARCHS)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes at once; torch's CPU ops
    in each take one thread (restored after the module)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    a = np.asarray(t)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _close(ours, ref, rtol, what=""):
    ours, ref = _np(ours).astype(np.float64), _np(ref).astype(np.float64)
    assert ours.shape == ref.shape, what
    scale = max(np.abs(ref).max(initial=0.0), 1e-30)
    err = np.abs(ours - ref).max(initial=0.0)
    assert err <= rtol * scale, f"{what}: {err} > {rtol} x {scale}"


def _ref_leaves(tree) -> dict:
    """Reference-layout leaves by ``/``-joined key."""
    from repro.core.engine import path_entry_name

    return {"/".join(path_entry_name(p) for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_as_ref(params, period) -> dict:
    return _ref_leaves(tree_map(lambda t: t.detach().numpy()
                                if t.dtype != torch.bfloat16 else t.float().numpy(),
                                params_to_ref(params, period)))


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["uniform", "packed", "embed", "mrope"])
def test_batch_at_is_bit_equal(kind):
    kw = dict(vocab=211, seq_len=24, global_batch=4, seed=7)
    kw.update({"packed": dict(packed=True, mean_doc_len=6),
               "embed": dict(embed_dim=16), "mrope": dict(mrope=True),
               "uniform": {}}[kind])
    jdc, tdc = jpipe.DataConfig(**kw), tpipe.DataConfig(**kw)
    for step in (0, 1, 5, 2 ** 31 + 3):
        jb, tb = jpipe.batch_at(jdc, step), tpipe.batch_at(tdc, step)
        assert sorted(jb) == sorted(tb)
        for k in jb:
            assert jb[k].dtype == tb[k].dtype and np.array_equal(jb[k], tb[k]), k
    for host in range(2):
        for k, v in jpipe.host_shard(jb, host, 2).items():
            assert np.array_equal(tpipe.host_shard(tb, host, 2)[k], v)
    jit, tit = jpipe.iterate(jdc, 3), tpipe.iterate(tdc, 3)
    for _ in range(2):
        jb, tb = next(jit), next(tit)
        assert all(np.array_equal(jb[k], tb[k]) for k in jb)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_for_model_is_equal(name):
    for packed in (False, True):
        j = jpipe.for_model(ARCHS[name], seq_len=32, global_batch=2, seed=3,
                            packed=packed)
        t = tpipe.for_model(treg.get(name), seq_len=32, global_batch=2, seed=3,
                            packed=packed)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)


# ---------------------------------------------------------------------------
# schedule and AdamW
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("warmup,total", [(10, 50), (0, 7), (5, 5)])
def test_warmup_cosine_is_equal(warmup, total):
    for step in range(total + 6):
        ref = float(jwarmup(jnp.asarray(step, jnp.int32), warmup, total))
        for s in (step, torch.tensor(step, dtype=torch.int32)):
            ours = warmup_cosine(s, warmup, total)
            assert ours.dtype == torch.float32
            assert abs(float(ours) - ref) <= SCHED_RTOL * max(abs(ref), 1e-30)
    assert constant(3, 0.5) == 0.5


def _opt_case(dtype, scale, seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"a": (5, 7), "b": {"c": (3,), "d": (2, 4, 3)}}
    params = jax.tree.map(lambda s: rng.normal(size=s).astype(np.float32),
                          shapes, is_leaf=lambda x: isinstance(x, tuple))
    grads = jax.tree.map(lambda s: (scale * rng.normal(size=s)).astype(np.float32),
                         shapes, is_leaf=lambda x: isinstance(x, tuple))
    jp = jax.tree.map(lambda a: jnp.asarray(a, dtype), params)
    tp = tree_map(lambda a: to_tensor(np.asarray(jnp.asarray(a, dtype))), params)
    return jp, tp, grads


def _opt_states_equal(tstate, jstate, tparams, jparams, bf16):
    assert int(tstate.step) == int(jstate.step)
    for tree_t, tree_j in ((tstate.master, jstate.master), (tstate.mu, jstate.mu),
                           (tstate.nu, jstate.nu)):
        for t, j in zip(leaves(tree_t), jax.tree.leaves(tree_j)):
            _close(t, j, OPT_RTOL)
    for t, j in zip(leaves(tparams), jax.tree.leaves(jparams)):
        _close(t, j, 2 ** -8 if bf16 else OPT_RTOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gscale", [0.01, 10.0])  # below / above clip_norm
def test_adamw_update_is_equal(dtype, gscale):
    cfg = dict(lr=1e-2, weight_decay=0.1, clip_norm=1.0)
    jp, tp, grads = _opt_case(getattr(jnp, dtype), gscale)
    jstate, tstate = jadamw.init(jp), tadamw.init(tp)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg), tadamw.AdamWConfig(**cfg)
    for step in range(3):
        g = jax.tree.map(lambda a: a * (1 + step), grads)
        jlr = jwarmup(jstate.step, 1, 10)
        jp, jstate, jm = jadamw.update(jax.tree.map(jnp.asarray, g), jstate, jp,
                                       jcfg, jlr)
        tlr = warmup_cosine(tstate.step, 1, 10)
        tp, tstate, tm = tadamw.update(tree_map(to_tensor, g), tstate, tp, tcfg, tlr)
        for k in ("grad_norm", "lr", "skipped"):
            _close(tm[k], jm[k], OPT_RTOL, k)
        assert float(tm["skipped"]) == 0.0
        _opt_states_equal(tstate, jstate, tp, jp, dtype == "bfloat16")
        assert all(p.dtype == getattr(torch, dtype) for p in leaves(tp))
    clipped = float(tm["grad_norm"]) > 1.0
    assert clipped == (gscale > 1)


def test_adamw_nan_guard_skips_the_step():
    jp, tp, grads = _opt_case(jnp.float32, 1.0)
    cfg = tadamw.AdamWConfig()
    tstate = tadamw.init(tp)
    tp, tstate, _ = tadamw.update(tree_map(to_tensor, grads), tstate, tp, cfg, 1.0)
    before = [t.clone() for t in leaves((tstate.master, tstate.mu, tstate.nu, tp))]
    bad = tree_map(to_tensor, grads)
    bad["b"]["c"][1] = float("inf")
    tp, after, m = tadamw.update(bad, tstate, tp, cfg, 1.0)
    assert (float(m["skipped"]), int(after.step)) == (1.0, 1)
    assert not np.isfinite(float(m["grad_norm"]))
    assert all(torch.equal(a, b) for a, b in zip(
        before, leaves((after.master, after.mu, after.nu, tp))))
    # the reference skips the same step the same way
    jstate = jadamw.init(jp)
    jbad = jax.tree.map(jnp.asarray, grads)
    jbad["b"]["c"] = jbad["b"]["c"].at[1].set(jnp.inf)
    _, js, jm = jadamw.update(jbad, jstate, jp, jadamw.AdamWConfig(), 1.0)
    assert (float(jm["skipped"]), int(js.step)) == (1.0, 0)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------
def _model(name, seed=0):
    jcfg = reduce_for_smoke(ARCHS[name])
    tcfg = treg.reduce_for_smoke(treg.get(name))
    jparams = jtrainer.init_model(jax.random.key(seed), jcfg)
    return jcfg, tcfg, jparams, params_from_jax(jparams)


def _batch(cfg, b=4, t=16, step=0):
    return jpipe.batch_at(jpipe.for_model(cfg, seq_len=t, global_batch=b,
                                          packed=True), step)


@pytest.mark.parametrize("name", ["qwen3-8b", "qwen2-moe-a2.7b", "mamba2-780m"])
def test_loss_and_grads_match_jax(name):
    jcfg, tcfg, jparams, tparams = _model(name)
    batch = _batch(jcfg)
    jloss, jgrads = jax.value_and_grad(jtrainer.loss_fn)(
        jparams, jax.tree.map(jnp.asarray, batch), jcfg)
    tloss, tgrads = ttrainer.value_and_grad(tparams, batch, tcfg)
    _close(tloss, jloss, GRAD_RTOL, "loss")
    ours, ref = _port_as_ref(tgrads, tcfg.period), _ref_leaves(jgrads)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        _close(ours[k], ref[k], GRAD_RTOL, k)


@pytest.mark.parametrize("policy", ["nothing", "dots"])
@pytest.mark.parametrize("name", ["qwen3-8b", "jamba-1.5-large-398b"])
def test_remat_gives_the_same_grads(name, policy):
    """Remat on and off: the same loss and gradients, bit for bit, and the
    forward keeps fewer tensors for the backward with it on."""
    _, tcfg, _, tparams = _model(name)
    batch = _batch(tcfg)
    out = {}
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat, remat_policy=policy)
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append(t.numel()) or t, lambda t: t):
            out[remat] = ttrainer.value_and_grad(tparams, batch, cfg)
        out[remat] += (sum(saved),)
    assert torch.equal(out[True][0], out[False][0])
    assert all(torch.equal(a, b) for a, b in zip(leaves(out[True][1]),
                                                  leaves(out[False][1])))
    assert out[True][2] < out[False][2]


def _train_cfgs(mb=2, **kw):
    common = dict(warmup_steps=2, total_steps=10, microbatches=mb, **kw)
    return (jtrainer.TrainConfig(opt=jadamw.AdamWConfig(lr=1e-3), **common),
            ttrainer.TrainConfig(opt=tadamw.AdamWConfig(lr=1e-3), **common))


def test_train_steps_match_the_reference():
    jcfg, tcfg, jparams, tparams = _model("qwen3-8b")
    jt, tt = _train_cfgs()
    jstep = jax.jit(jtrainer.make_train_step(jcfg, jt))
    tstep = ttrainer.make_train_step(tcfg, tt)
    jstate = jtrainer.TrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                                 opt=jadamw.init(jparams))
    tstate = ttrainer.state_from_params(tparams)
    for step in range(3):
        batch = _batch(jcfg, step=step)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        tstate, tm = tstep(tstate, batch)
        for k in ("loss", "grad_norm", "lr"):
            _close(tm[k], jm[k], GRAD_RTOL, k)
        assert float(tm["skipped"]) == 0.0 and int(tstate.step) == step + 1
    ours, ref = _port_as_ref(tstate.params, 1), _ref_leaves(jstate.params)
    for k in ref:
        np.testing.assert_allclose(ours[k], np.asarray(ref[k]), rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)


def test_microbatches_accumulate_in_float32(monkeypatch):
    """Two microbatches of bf16 params: the accumulated gradient is the
    float32 mean of the microbatches' bf16 gradients, as the reference's
    scan forms it."""
    _, tcfg, _, tparams = _model("qwen3-8b")
    cfg = dataclasses.replace(tcfg, param_dtype="bfloat16")
    params = tree_map(lambda t: t.to(torch.bfloat16), tparams)
    batch = _batch(cfg)
    halves = [{k: v[i * 2:(i + 1) * 2] for k, v in batch.items()} for i in range(2)]
    grads = [ttrainer.value_and_grad(params, h, cfg)[1] for h in halves]
    want = tree_map(lambda a, b: torch.zeros(a.shape).add_(a / 2).add_(b / 2),
                    grads[0], grads[1])
    seen = {}
    update = tadamw.update

    def spy(g, *args):
        seen["g"] = g
        return update(g, *args)

    monkeypatch.setattr(tadamw, "update", spy)
    ttrainer.make_train_step(cfg, _train_cfgs()[1])(
        ttrainer.state_from_params(params), batch)
    assert all(g.dtype == torch.float32 and torch.equal(g, w)
               for g, w in zip(leaves(seen["g"]), leaves(want)))


# ---------------------------------------------------------------------------
# trainer: checkpoints, resume, replay, stragglers
# ---------------------------------------------------------------------------
def _trainer_run(tmp, steps, ckpt=True, fail_at=None, seed=0, every=2):
    _, tcfg, _, _ = _model("qwen3-8b")
    dc = tpipe.for_model(tcfg, seq_len=16, global_batch=4, packed=True)
    _, tt = _train_cfgs(ckpt_dir=str(tmp) if ckpt else None, ckpt_every=every)
    failed = []

    def data(step):
        if step == fail_at and not failed:
            failed.append(step)
            raise RuntimeError("injected step failure")
        return tpipe.batch_at(dc, step)

    trainer = ttrainer.Trainer(tcfg, tt, data)
    state = ttrainer.init_state(tcfg, seed=seed, device="cpu")
    return (*trainer.run(state, steps), failed)


def test_resume_equals_a_straight_run(tmp_path):
    straight, hist, _ = _trainer_run(tmp_path / "a", 6)
    _trainer_run(tmp_path / "b", 4)
    # a fresh process would start from other weights: the checkpoint wins
    resumed, rhist, _ = _trainer_run(tmp_path / "b", 6, seed=1)
    assert [h["step"] for h in rhist] == [4, 5]
    assert [h["loss"] for h in rhist] == [h["loss"] for h in hist[4:]]
    assert all(torch.equal(a, b) for a, b in zip(leaves(resumed), leaves(straight)))
    assert tckpt.all_steps(str(tmp_path / "b")) == [2, 4, 6]


def test_a_failed_step_is_replayed_from_the_checkpoint(tmp_path):
    straight, hist, _ = _trainer_run(tmp_path / "a", 6)
    state, rhist, failed = _trainer_run(tmp_path / "b", 6, fail_at=3)
    assert failed == [3]
    # steps 2 runs twice: once before the failure, once replayed
    assert [h["step"] for h in rhist] == [0, 1, 2, 2, 3, 4, 5]
    assert [h["loss"] for h in rhist[3:]] == [h["loss"] for h in hist[2:]]
    assert all(torch.equal(a, b) for a, b in zip(leaves(state), leaves(straight)))


def test_without_a_checkpoint_dir_the_error_propagates(tmp_path):
    with pytest.raises(RuntimeError, match="injected"):
        _trainer_run(tmp_path, 4, ckpt=False, fail_at=1)


def test_straggler_flags_are_equal():
    rng = np.random.default_rng(0)
    times = list(rng.uniform(0.9, 1.1, 30)) + [5.0, 1.0, 1.0, 3.0] + [1.0] * 5
    j, t = jtrainer.StragglerMonitor(z=3.0), ttrainer.StragglerMonitor(z=3.0)
    assert [j.observe(x) for x in times] == [t.observe(x) for x in times]
    assert (j.flagged, j.mean, j.var) == (t.flagged, t.mean, t.var) and t.flagged >= 1


# ---------------------------------------------------------------------------
# step checkpoints across the packages
# ---------------------------------------------------------------------------
def _states(name="qwen2-moe-a2.7b", dtype="bfloat16"):
    """A reference TrainState and the port's, of the same bf16 params, one
    AdamW step apart from init so every leaf is distinct."""
    jcfg, tcfg, jparams, _ = _model(name)
    jcfg = dataclasses.replace(jcfg, param_dtype=dtype)
    jparams = jax.tree.map(lambda a: a.astype(dtype), jparams)
    jstate = jtrainer.TrainState(step=jnp.asarray(3, jnp.int32), params=jparams,
                                 opt=jadamw.init(jparams))
    g = jax.tree.map(lambda a: jnp.ones(a.shape, jnp.float32) * 0.1, jparams)
    _, opt, _ = jadamw.update(g, jstate.opt, jparams, jadamw.AdamWConfig(), 1.0)
    jstate = jstate._replace(opt=opt)
    tstate = ttrainer.TrainState(
        step=torch.tensor(3, dtype=torch.int32),
        params=params_from_jax(jstate.params),
        opt=tadamw.AdamWState(step=to_tensor(opt.step),
                              master=params_from_jax(opt.master),
                              mu=params_from_jax(opt.mu),
                              nu=params_from_jax(opt.nu)))
    return jcfg, tcfg, jstate, tstate


def _states_equal(jstate, tstate, period):
    ours = _ref_leaves(_to_ref_np(tstate, period))
    ref = _ref_leaves(jstate)
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        assert np.asarray(v).dtype == ours[k].dtype, k
        assert np.array_equal(np.asarray(v).reshape(-1).view(np.uint8),
                              ours[k].reshape(-1).view(np.uint8)), k


def _to_ref_np(tstate, period):
    def arr(t):
        t = t.detach().contiguous()
        if t.dtype == torch.bfloat16:
            import ml_dtypes

            return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()

    return {"step": arr(tstate.step), "params": jax.tree.map(
        arr, params_to_ref(tstate.params, period)),
        "opt": {"step": arr(tstate.opt.step),
                **{f: jax.tree.map(arr, params_to_ref(getattr(tstate.opt, f), period))
                   for f in ("master", "mu", "nu")}}}


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    jcfg, tcfg, jstate, tstate = _states()
    tckpt.save(str(tmp_path), 3, tstate, period=tcfg.period)
    template = jax.tree.map(jnp.zeros_like, jstate)
    restored = jckpt.restore(str(tmp_path), 3, template)
    _states_equal(restored, tstate, tcfg.period)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jcfg, tcfg, jstate, tstate = _states()
    jckpt.save(str(tmp_path), 5, jstate)
    template = tree_map(torch.zeros_like, tstate)
    restored = tckpt.restore(str(tmp_path), 5, template, period=tcfg.period)
    assert type(restored) is ttrainer.TrainState
    assert type(restored.opt) is tadamw.AdamWState
    assert restored.params["blocks"][0]["mixer"]["wq"].dtype == torch.bfloat16
    _states_equal(jstate, restored, tcfg.period)
    # a corrupted array fails its checksum
    path = os.path.join(str(tmp_path), "step_00000005", "arrays.npz")
    with np.load(path) as data:
        arrays = dict(data)
    arrays["step"] = np.asarray(4, np.int32)
    np.savez(path, **arrays)
    with pytest.raises(IOError, match="checksum"):
        tckpt.restore(str(tmp_path), 5, template, period=tcfg.period)


def test_step_checkpoint_gc_and_steps(tmp_path):
    tree = {"a": torch.arange(4.0), "n": [torch.ones(2, dtype=torch.bfloat16)]}
    for s in range(5):
        tckpt.save(str(tmp_path), s, tree, keep=2)
    assert tckpt.all_steps(str(tmp_path)) == [3, 4] == jckpt.all_steps(str(tmp_path))
    assert tckpt.latest_step(str(tmp_path)) == 4
    assert tckpt.latest_step(str(tmp_path / "none")) is None
    out = tckpt.restore(str(tmp_path), 4, tree)
    assert torch.equal(out["a"], tree["a"]) and out["n"][0].dtype == torch.bfloat16


def test_async_checkpointer_raises_the_writers_error(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ac = tckpt.AsyncCheckpointer(str(blocker), keep=2)
    ac.submit(1, {"a": torch.ones(3)})
    with pytest.raises(OSError):
        ac.wait()
    with pytest.raises(OSError):
        ac.submit(2, {"a": torch.ones(3)})
    good = tckpt.AsyncCheckpointer(str(tmp_path / "ok"), keep=2)
    live = {"a": torch.zeros(3)}
    good.submit(1, live)
    live["a"].add_(1)  # the step goes on updating in place
    good.wait()
    good.close()
    assert torch.equal(tckpt.restore(str(tmp_path / "ok"), 1, live)["a"],
                       torch.zeros(3))


# ---------------------------------------------------------------------------
# the training launcher
# ---------------------------------------------------------------------------
def test_train_launcher_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train

    train.main(["--arch", "qwen3-8b", "--smoke", "--steps", "2", "--batch", "4",
                "--seq", "16", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=qwen3-8b params=") and out[-1] == "done at step 2"
    assert [line.split()[1] for line in out if line.startswith("step")] == ["0", "1"]
    d = str(tmp_path / "ck")
    args = ["--arch", "qwen3-8b", "--smoke", "--batch", "4", "--seq", "16",
            "--device", "cpu", "--ckpt-dir", d, "--ckpt-every", "2"]
    train.main(args + ["--steps", "2"])
    capsys.readouterr()
    train.main(args + ["--steps", "3"])
    out = capsys.readouterr().out.splitlines()
    assert [line.split()[1] for line in out if line.startswith("step")] == ["2"]
    shutil.rmtree(d)


@pytest.mark.parametrize("extra", [["--mesh", "2x2"], ["--fake-devices", "4"]])
def test_train_launcher_refuses_a_mesh(extra):
    from repro_torch.launch import train

    with pytest.raises(SystemExit, match="distributed slice"):
        train.main(["--arch", "qwen3-8b", "--smoke", "--device", "cpu"] + extra)


def test_train_launcher_without_a_card_raises():
    from repro_torch.launch import train

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        train.main(["--arch", "qwen3-8b", "--smoke", "--steps", "1"])
