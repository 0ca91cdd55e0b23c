"""Device-side token selection for the serving engine: sampling + EOS
(PyTorch port).

The same policy law as the JAX package's ``runtime/sampling.py``:

1. **Greedy stays exact.** A greedy row (``temperature <= 0``) takes
   ``argmax(logits.float())``. When every row is greedy the caller passes no
   noise and the sampling work is skipped — the host knows the per-slot
   policy, so this decision costs no device sync.

2. **Replay determinism.** Randomness is a pure function of the request's key
   and the *position* being sampled, not of how many steps the engine ran:
   :func:`gumbel_noise` draws row ``b``'s noise as
   ``gumbel(fold_in(key_b, pos_b))``, so eviction-by-recompute replays a
   sampled stream exactly. The token emitted after processing position ``p``
   is sampled at ``p``.

The keys and the noise are the reference's own: ``runtime/prng.py`` is a copy
of JAX's threefry-2x32 sampler in integer tensor ops, so the request keys and
the uniform bits equal ``jax.random``'s bit for bit, and the Gumbel values
differ from XLA's only where the two ``log`` implementations round apart (at
most 2 ulp of ``max(|g|, 1)``). :func:`sample_tokens` takes the noise as an
argument, so the tests can also feed it the reference's noise directly.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import prng


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decode policy. ``temperature <= 0`` means greedy (then
    ``top_k``/``top_p`` are ignored, but repetition penalties still apply);
    ``top_k == 0`` samples the full vocabulary; ``top_p == 1.0`` disables the
    nucleus filter. ``presence_penalty`` subtracts a flat penalty from every
    token the request has already emitted; ``frequency_penalty`` subtracts
    proportionally to each token's emission count."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        for name in ("presence_penalty", "frequency_penalty"):
            v = getattr(self, name)
            if not -2.0 <= v <= 2.0:
                raise ValueError(f"{name} must be in [-2, 2], got {v}")

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0

    @property
    def penalized(self) -> bool:
        return self.presence_penalty != 0.0 or self.frequency_penalty != 0.0


GREEDY = SamplingParams()


def request_key(sampling: SamplingParams, rid: int) -> np.ndarray:
    """The request's PRNG key (uint32[2]), snapshotted at admission: the
    reference's ``fold_in(PRNGKey(seed), rid)``. Derived only from
    user-visible fields — (seed, rid) — so two engines fed the same workload
    in the same order sample identical streams."""
    return prng.fold_in(prng.PRNGKey(sampling.seed), rid).numpy().astype(
        np.uint32)


def gumbel_noise(keys, positions, vocab: int, device, rows=None):
    """Gumbel noise ``[B, vocab]`` float32: row ``b`` is the reference's
    ``jax.random.gumbel(fold_in(keys[b], positions[b]), (vocab,))``. ``keys``
    [B, 2] uint32 words; ``rows`` (default: all) lists the rows that need
    noise, drawn in one batched call on ``device``; the others stay zero
    (greedy rows ignore it)."""
    keys = np.asarray(keys, np.int64).reshape(-1, 2)
    positions = np.asarray(positions, np.int64).reshape(-1)
    rows = list(range(len(keys)) if rows is None else rows)
    out = torch.zeros((len(keys), vocab), dtype=torch.float32, device=device)
    if rows:
        # fancy indexing copies: the host arrays may change after the upload
        k = torch.from_numpy(keys[rows]).to(device)
        p = torch.from_numpy(positions[rows]).to(device)
        out[torch.tensor(rows, device=device)] = prng.gumbel(
            prng.fold_in(k, p), vocab)
    return out


def policy_mask(lg, top_ks, top_ps=None):
    """Token support of the per-row sampling policy: bool [B, V].

    ``lg`` [B, V] f32 raw logits; ``top_ks`` [B] (<= 0 keeps the full vocab);
    ``top_ps`` [B] f32 or None (None / >= 1.0 disables the nucleus filter).
    Top-k is a cutoff on the raw logits; top-p keeps the smallest prefix of
    the probability-sorted vocabulary whose cumulative probability reaches
    ``top_p`` (the argmax token always kept). The sort is stable, as
    ``jnp.argsort`` is: the top-p order of equal logits depends on it.
    """
    V = lg.shape[-1]
    top_ks = top_ks.long()
    k_eff = torch.where(top_ks <= 0, V, torch.clamp(top_ks, 1, V))
    order = torch.argsort(-lg, dim=-1, stable=True)
    desc = torch.gather(lg, -1, order)
    kth = torch.gather(desc, -1, (k_eff - 1)[:, None])
    mask = lg >= kth
    if top_ps is None:
        return mask
    probs = torch.softmax(lg, dim=-1)
    sp = torch.gather(probs, -1, order)
    cum = torch.cumsum(sp, dim=-1)
    keep_sorted = (cum - sp) < top_ps[:, None]
    pmask = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
    # top_p >= 1 keeps everything exactly (cumsum rounding must not drop
    # tail tokens when the filter is off)
    return mask & (pmask | (top_ps >= 1.0)[:, None])


def masked_probs(logits, temps, top_ks, top_ps=None):
    """The per-row policy distribution as explicit probabilities: f32 [B, V].
    Greedy rows (``temps <= 0``) return a one-hot at the argmax."""
    lg = logits.float()
    scaled = lg / torch.clamp(temps, min=1e-6)[:, None]
    mask = policy_mask(lg, top_ks, top_ps)
    p = torch.softmax(torch.where(mask, scaled, float("-inf")), dim=-1)
    greedy = torch.nn.functional.one_hot(
        torch.argmax(lg, dim=-1), lg.shape[-1]).float()
    return torch.where((temps <= 0)[:, None], greedy, p)


def apply_penalties(lg, counts, presence, frequency):
    """Repetition-penalized logits: ``lg - presence * 1[count > 0] -
    frequency * count`` (f32 [B, V]). With both penalties zero this is
    bitwise ``lg``: subtracting exact zeros changes no value."""
    c = counts.float()
    return (lg - presence[:, None] * (c > 0).float()
            - frequency[:, None] * c)


def sample_tokens(logits, gumbel, temps, top_ks, top_ps=None, counts=None,
                  presence=None, frequency=None):
    """Select one token per row. ``logits`` [B, V] (any float dtype);
    ``gumbel`` [B, V] f32 noise, or None when every row is greedy; ``temps``
    [B] f32; ``top_ks`` [B]; ``top_ps`` [B] f32 or None. Optional repetition
    penalties: ``counts`` [B, V] with ``presence``/``frequency`` [B]. Returns
    int64 [B].

    Greedy rows take the argmax (of the penalized logits, when penalties are
    given); others the Gumbel-max of the temperature-scaled,
    top-k/top-p-masked logits.
    """
    lg = logits.float()
    if counts is not None:
        lg = apply_penalties(lg, counts, presence, frequency)
    gtok = torch.argmax(lg, dim=-1)
    if gumbel is None:
        return gtok
    scaled = lg / torch.clamp(temps, min=1e-6)[:, None]
    masked = torch.where(policy_mask(lg, top_ks, top_ps), scaled,
                         float("-inf"))
    stok = torch.argmax(masked + gumbel, dim=-1)
    return torch.where(temps <= 0, gtok, stok)


def decode_select(logits, gumbel, temps, top_ks, eos_ids, finished,
                  top_ps=None, counts=None, presence=None, frequency=None):
    """One hot-loop selection step: sample, then fold the EOS finished mask.

    ``eos_ids`` [B] with -1 meaning "no EOS for this row"; ``finished`` [B]
    bool. A finished row keeps emitting its EOS token (the host truncates at
    finalize) and a row that just emitted its EOS becomes finished. Returns
    (tokens int64 [B], finished).
    """
    nxt = sample_tokens(logits, gumbel, temps, top_ks, top_ps, counts=counts,
                        presence=presence, frequency=frequency)
    eos_ids = eos_ids.long()
    fill = torch.where(eos_ids >= 0, eos_ids, 0)
    nxt = torch.where(finished, fill, nxt)
    finished = finished | ((eos_ids >= 0) & (nxt == eos_ids))
    return nxt, finished
