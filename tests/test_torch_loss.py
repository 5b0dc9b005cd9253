"""PyTorch port vs the JAX reference: the fused token cross-entropy.

``models/model.py: lm_loss`` runs through one ``autograd.Function``
(``_CrossEntropy``): the forward reads the logits in their own dtype and
keeps each row's log-sum-exp; the backward writes ``(softmax − one_hot) ·
g`` into one float32 buffer of the logits' shape, or a block of rows at a
time.  Held here, on seeded logits in float32 and bfloat16 with labels at
vocab index 0 and V − 1:

* the loss within ``LOSS_RTOL`` and the gradient within ``GRAD_ATOL``
  (float32) or one bfloat16 ulp of JAX's ``lm_loss`` under ``jax.grad``
  and of the eager chain the port ran before (upcast, ``logsumexp``,
  gather);
* the vocab-parallel form (logits placed on a mesh, the vocab split over
  the model axis, and the rows too on (2, 2)) against one device, on four
  gloo ranks;
* on fake tensors, the backward's peak (MemTracker) at most the logits
  plus one float32 buffer of their shape.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models.model import lm_loss as jlm_loss
from repro_torch.models.model import lm_loss

LOSS_RTOL, GRAD_ATOL = 1e-6, 1e-6
B, T, V = 3, 7, 100


def _inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(B, T, V)) * 3).astype(np.float32)
    labels = rng.integers(0, V, (B, T)).astype(np.int32)
    labels[0, :3] = 0
    labels[1, :3] = V - 1
    return logits, labels


def _eager(logits, labels):
    """The port's loss before the fused form: the autograd chain."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


def _torch_grad(fn, logits, labels, dtype):
    x = torch.as_tensor(logits).to(dtype).requires_grad_()
    loss = fn(x, torch.as_tensor(labels))
    (g,) = torch.autograd.grad(loss, x)
    return float(loss.detach()), g


def _bf16_bits(g) -> np.ndarray:
    return np.asarray(g.view(torch.int16), dtype=np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_loss_matches_jax_and_the_eager_chain(dtype):
    logits, labels = _inputs()
    tdt = getattr(torch, dtype)
    loss, g = _torch_grad(lm_loss, logits, labels, tdt)
    e_loss, e_g = _torch_grad(_eager, logits, labels, tdt)
    j_loss, j_g = jax.value_and_grad(jlm_loss)(
        jnp.asarray(logits).astype(getattr(jnp, dtype)), jnp.asarray(labels))
    assert g.dtype == tdt
    for ref in (float(j_loss), e_loss):
        assert loss == pytest.approx(ref, rel=LOSS_RTOL)
    if dtype == "float32":
        np.testing.assert_allclose(g.numpy(), np.asarray(j_g), rtol=0, atol=GRAD_ATOL)
        np.testing.assert_allclose(g.numpy(), e_g.numpy(), rtol=0, atol=GRAD_ATOL)
    else:
        j_bits = np.asarray(jax.lax.bitcast_convert_type(j_g, jnp.int16), np.int32)
        assert np.abs(_bf16_bits(g) - j_bits).max() <= 1
        assert np.abs(_bf16_bits(g) - _bf16_bits(e_g)).max() <= 1


def test_fused_loss_row_blocks_change_nothing(monkeypatch):
    """A block of one row at a time gives the one-block result bit for
    bit, in both dtypes."""
    from repro_torch.models import model as M

    logits, labels = _inputs(1)
    for dtype in (torch.float32, torch.bfloat16):
        whole = _torch_grad(lm_loss, logits, labels, dtype)
        monkeypatch.setattr(M, "_LOSS_BLOCK_BYTES", 4 * V)
        rows = _torch_grad(lm_loss, logits, labels, dtype)
        monkeypatch.undo()
        assert whole[0] == rows[0] and torch.equal(whole[1], rows[1])


# ---------------------------------------------------------------------------
# vocab-parallel, on gloo ranks (module level: the spawned ranks import it)
# ---------------------------------------------------------------------------
def _vocab_parallel():
    """The loss and gradient of logits placed with the vocab split over
    the model axis of (1, 4), and rows and vocab on (2, 2), against one
    device's, in both dtypes."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import make_test_mesh

    logits, labels = _inputs(2)
    lab = torch.as_tensor(labels)
    out = {}
    for shape, pl in (((1, 4), [Replicate(), Shard(2)]),
                      ((2, 2), [Shard(0), Shard(2)])):
        mesh = make_test_mesh(shape, ("data", "model"))
        for dtype in (torch.float32, torch.bfloat16):
            one = _torch_grad(lm_loss, logits, labels, dtype)
            x = distribute_tensor(torch.as_tensor(logits).to(dtype), mesh, pl,
                                  src_data_rank=None).requires_grad_()
            loss = lm_loss(x, lab)
            (g,) = torch.autograd.grad(loss.to_local(), x)
            out[f"{shape} {dtype}"] = {
                "loss": (float(loss.to_local()), one[0]),
                "grad": (g.full_tensor().float().numpy(), one[1].float().numpy()),
                "placed_as_logits": tuple(g.placements) == tuple(pl)}
    return out


def test_vocab_parallel_loss_matches_one_device(tmp_path):
    from repro_torch.launch.mesh import spawn

    torch.set_num_threads(1)
    out = spawn(_vocab_parallel, 4, init_dir=str(tmp_path))
    for rank in out:
        for key, got in rank.items():
            sharded, one = got["loss"]
            assert sharded == pytest.approx(one, rel=LOSS_RTOL), key
            assert got["placed_as_logits"], key
            atol = GRAD_ATOL if "float32" in key else 2.0 ** -7 * np.abs(got["grad"][1])
            assert (np.abs(got["grad"][0] - got["grad"][1]) <= atol).all(), key


# ---------------------------------------------------------------------------
# the backward's peak, on fake tensors
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_holds_one_float32_buffer(dtype):
    """MemTracker's peak over the loss and its backward: the logits (an
    argument) plus at most one float32 buffer of their shape, and a few
    per-row vectors; the eager chain held four."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.dryrun import _mem_tracker

    b, t, v = 4, 64, 5000
    with FakeTensorMode():
        x = torch.empty(b, t, v, dtype=dtype, requires_grad=True)
        labels = torch.zeros(b, t, dtype=torch.int64)
        peaks = {}
        for name, fn in (("fused", lm_loss), ("eager", _eager)):
            tracker = _mem_tracker()
            tracker.track_external(x, labels)
            with tracker:
                torch.autograd.grad(fn(x, labels), x)
            peaks[name] = max(snap.get("Total", 0) for snap in
                              tracker.get_tracker_snapshot("peak").values())
    logits, f32 = x.numel() * x.element_size(), 4 * x.numel()
    rows = 64 * b * t * 8                      # per-row vectors, generously
    assert peaks["fused"] <= logits + f32 + rows, (peaks, logits, f32)
    assert peaks["eager"] > logits + 2 * f32, peaks
