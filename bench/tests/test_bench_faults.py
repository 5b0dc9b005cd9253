"""Whole runs of a cell on the CPU at test widths (the harness's look for
a card skipped): sound, ``correct`` holds; with the timed path broken
underneath, it comes out false.  The faults a served cell can have: a
token altered where it is produced, and a step that leaves its state (the
KV pages) unchanged."""
from __future__ import annotations

import time

import pytest
import torch

from bench import manifest as mf
from bench import serve
from tiny import tiny_config, tiny_mix

#: each cell, and the port's MoE (a family no cell serves yet, its
#: stand-in config under ``tests/configs``) under the chat cell's limit
CELLS = [("minitron-8b.chat-b128", "minitron-8b", "chat-b128"),
         ("minitron-8b.longprompt-b64", "minitron-8b", "longprompt-b64"),
         ("minitron-8b.chat-b128", "qwen2-moe-a2.7b", "chat-b128")]


def _run(cell, config, traffic, seed=2**31 + 21, tamper=None, device="cpu", trace=False,
         seconds=1.5):
    man = mf.load()
    w = mf.cell(man, cell)
    return serve.run_cell(w, tiny_config(config), tiny_mix(traffic), seed, seconds, trace,
                          device, time.perf_counter(), mf.limit_of(w), tamper=tamper)


def _alter_tokens(eng):
    """Every token the scheduler emits replaced by another id."""
    rt = eng._rt
    emit, vocab = rt._emit, rt.cfg.vocab

    def altered(i, lane, tok, now):
        return emit(i, lane, (tok + vocab // 2) % vocab, now)

    rt._emit = altered


def _freeze_pages(monkeypatch):
    """K/V rows never written: each step leaves the page pool as it was."""
    from repro_torch.models import attention

    monkeypatch.setattr(attention, "_write_rows", lambda pool, page_ids, off, rows: None)


@pytest.mark.parametrize("cell,config,traffic", CELLS)
def test_sound_run_is_correct(cell, config, traffic):
    res = _run(cell, config, traffic)
    assert res["correct"], res["gap"]
    assert res["sample"] and res["attempted"] >= 1


@pytest.mark.parametrize("cell,config,traffic", CELLS)
def test_altered_token_is_caught(cell, config, traffic):
    res = _run(cell, config, traffic, tamper=_alter_tokens)
    assert not res["correct"], res["gap"]


@pytest.mark.parametrize("cell,config,traffic", CELLS)
def test_unwritten_state_is_caught(cell, config, traffic, monkeypatch):
    _freeze_pages(monkeypatch)
    res = _run(cell, config, traffic)
    assert not res["correct"], res["gap"]


def test_control_reads_above_the_program():
    """The control (activations on their top 4 bit-planes) on one run's
    sample reads well above the program at test widths, as it does at the
    cell's size on the card (``bench/control.py``)."""
    from bench.control import control_gap
    from bench.model import model_of

    res = _run("minitron-8b.chat-b128", "minitron-8b", "chat-b128")
    ctl = control_gap(model_of(tiny_config("minitron-8b")), 2**31 + 21, res["sample"], "cpu")
    assert ctl >= 3 * res["gap"] and ctl > res["limit"]


def test_traced_run_reads_the_layers_it_can():
    """A traced run on the CPU: the scheduler's readers read, the device's
    find no device activity and return nothing.  The window is long enough
    to reach the slice's ticks (``serve.SLICE_START`` on)."""
    from bench.readers import load_reader

    res = _run("minitron-8b.chat-b128", "qwen2-moe-a2.7b", "chat-b128", trace=True,
               seconds=8.0)
    data = res["data"]
    assert data.slice is not None and data.slice.ticks == serve.SLICE_TICKS
    assert load_reader("tick_ms")(data) > 0
    assert 0 < load_reader("decode_occupancy")(data) <= 100
    assert load_reader("device_idle_share")(data) is None


@pytest.mark.gpu
def test_card_run_is_correct_and_catches_a_fault(cuda):
    """The same at test widths on the card, through the port's kernels."""
    assert _run("minitron-8b.chat-b128", "minitron-8b", "chat-b128", device="cuda")["correct"]
    bad = _run("minitron-8b.chat-b128", "minitron-8b", "chat-b128", device="cuda",
               tamper=_alter_tokens)
    assert not bad["correct"]
    torch.cuda.empty_cache()
