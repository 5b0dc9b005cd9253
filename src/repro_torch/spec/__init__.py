"""Speculative decoding over the paged serving runtime (DA-native drafts).

Draft ``gamma`` tokens with a cheap pass, verify them in one batched
full-precision step through the paged runtime, and keep the verified prefix:
greedy acceptance makes the output token-identical to plain decoding.  Three
draft providers behind one :class:`DraftProvider` protocol:

* ``bitplane``  — truncated-bitplane self-draft: the same frozen artifact
  evaluated on the top ``draft_x_bits`` of its ``x_bits`` bit-planes.
* ``layerskip`` — early-exit self-draft over the first ``draft_periods``
  period groups of the same weights.
* ``artifact``  — a second, smaller frozen model sharing the vocabulary.

The scheduler side (draft/verify batching, acceptance EMA, auto-disable,
page checkpoint/rollback) lives in :mod:`repro_torch.serve.scheduler`.
"""
from repro_torch.spec.decode import (  # noqa: F401
    SpecConfig,
    breakeven_acceptance,
    greedy_accept,
    make_verify_step,
)
from repro_torch.spec.providers import (  # noqa: F401
    ArtifactDraft,
    DraftProvider,
    LayerSkipDraft,
    TruncatedBitplaneDraft,
    make_provider,
)
