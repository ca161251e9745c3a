"""Speculative decoding: draft-model propose, target-model verify
(``oim_tpu/serve/spec.py``).

A small DRAFT model proposes K tokens per decode slot by running the
ordinary paged ``decode_step`` over its own small page pool, and the
TARGET model verifies all K in ONE ``models/generate.py verify_step``
forward. Each row then emits its longest accepted prefix plus one token
the target supplies: 1..K+1 tokens for one target forward.

* ``accept_tokens``: the acceptance math on tensors. Greedy rows accept a
  proposal iff it equals the target's argmax, so greedy output equals solo
  ``generate()`` by construction. Sampled rows run the standard ratio test
  (accept d with probability min(1, p(d)/q(d)), resample rejections from
  the normalized residual max(p - q, 0)), which leaves the output
  distribution exactly the target's for any draft q.
* ``AcceptanceValve``: the adaptive fallback to plain decode when the
  rolling acceptance rate stops paying for the draft forwards (copied).

Randomness: the reference splits each row's key K+2 ways a round (carry,
K acceptance uniforms, one final sample). Here a sampled row draws K+1
uniforms from its request's generator each round, in one call and the
same order every round (K acceptance tests, then the final sample); the
generator's advanced state is the carry. The draft samples from its own
generator, seeded ``seed ^ DRAFT_KEY_FOLD``, so the ratio test's uniforms
are independent of the draws that picked the proposals.
"""

from __future__ import annotations

import collections

import torch

from oim_tpu_torch.models.generate import inverse_cdf

# Decorrelates the draft model's sampling chain from the target/accept
# chain: the draft generator is seeded with ``seed ^ DRAFT_KEY_FOLD``.
DRAFT_KEY_FOLD = 0x5BEC


def accept_tokens(logits, draft_tokens, draft_logits, temps, uniforms,
                  spec_mask):
    """The acceptance half of a verify round.

    Arguments (B rows, K proposals per row):
      logits        [B, K+1, V] target logits: position i holds the target
                    distribution for the token AFTER input i (input 0 is
                    the row's previous token, inputs 1..K the proposals).
      draft_tokens  [B, K] the proposals.
      draft_logits  [B, K, V] the draft distribution each proposal was
                    drawn from.
      temps         [B] request temperatures (0 = greedy).
      uniforms      [B, K+1] U[0,1) draws of the sampled rows: columns
                    0..K-1 the acceptance tests, column K the final sample
                    (ignored on greedy rows).
      spec_mask     [B] bool; False rows (no draft slot, or an idle row)
                    ignore the proposals and emit ONE token drawn from (or
                    argmaxed over) the target's first position: a plain
                    decode step.

    Returns (out_tokens [B, K+1], n_emit [B]): row b emits
    out_tokens[b, :n_emit[b]], its accepted prefix and then one
    target-supplied token.
    """
    B, K1, V = logits.shape
    K = K1 - 1
    rows = torch.arange(B, device=logits.device)
    safe = torch.where(temps > 0, temps, torch.ones_like(temps))[:, None, None]
    p = torch.softmax(logits / safe, dim=-1)        # [B, K+1, V]
    q = torch.softmax(draft_logits / safe, dim=-1)  # [B, K, V]
    d = draft_tokens.long()
    p_d = torch.gather(p[:, :K], 2, d[..., None])[..., 0]
    q_d = torch.gather(q, 2, d[..., None])[..., 0]
    # q(d) can underflow to 0 for a proposal the draft nonetheless emitted;
    # the clamp turns the ratio into "accept", the only answer consistent
    # with d having been drawn from q at all.
    ratio_ok = uniforms[:, :K] < p_d / torch.clamp(q_d, min=1e-38)
    greedy_tgt = logits.argmax(dim=-1)  # [B, K+1]
    greedy_ok = d == greedy_tgt[:, :K]
    accept = torch.where(temps[:, None] > 0, ratio_ok, greedy_ok)
    accept = accept & spec_mask[:, None]
    # a = longest accepted PREFIX.
    a = torch.cumprod(accept.long(), dim=1).sum(dim=1)

    # The one target-supplied token closing the round:
    #   rejected at i < K  -> residual max(p_i - q_i, 0), normalized;
    #   all K accepted     -> bonus from p_K;
    #   non-spec row       -> p_0, a plain decode step's sample.
    j = torch.clamp(a, max=K - 1)
    resid = torch.clamp(p[rows, j] - q[rows, j], min=0.0)
    rsum = resid.sum(dim=-1, keepdim=True)
    # p == q makes rejection probability 0 exactly; if f32 rounding lands
    # here with an all-zero residual, the target itself is the fallback.
    resid = torch.where(rsum > 0, resid / torch.clamp(rsum, min=1e-38), p[rows, j])
    use_p = (~spec_mask) | (a == K)
    dist = torch.where(use_p[:, None], p[rows, a], resid)
    sampled = inverse_cdf(dist, uniforms[:, K])
    final = torch.where(temps > 0, sampled, greedy_tgt[rows, a])

    idx = torch.arange(K + 1, device=logits.device)[None, :]
    d_pad = torch.cat([d, torch.zeros_like(d[:, :1])], dim=1)
    out = torch.where(idx < a[:, None], d_pad,
                      torch.where(idx == a[:, None], final[:, None], 0))
    return out, a + 1


class AcceptanceValve:
    """The adaptive spec-on/spec-off switch: a rolling window of verify
    rounds' (proposed, accepted) counts. When the window fills and the
    acceptance rate sits below ``floor``, the valve CLOSES (the engine
    releases every draft slot and decodes plainly); after
    ``reprobe_rounds`` plain rounds it reopens for new admissions. Only the
    engine thread drives it (stats readers tolerate torn reads of two
    ints)."""

    def __init__(self, floor: float = 0.3, window_rounds: int = 64,
                 reprobe_rounds: int = 256):
        if not 0.0 <= floor <= 1.0:
            raise ValueError(f"acceptance floor must be in [0, 1], "
                             f"got {floor}")
        if window_rounds < 1 or reprobe_rounds < 1:
            raise ValueError("window_rounds and reprobe_rounds must be "
                             ">= 1")
        self.floor = floor
        self.window_rounds = window_rounds
        self.reprobe_rounds = reprobe_rounds
        self._window: collections.deque[tuple[int, int]] = \
            collections.deque(maxlen=window_rounds)
        # Running window sums: rate() is read from other threads while the
        # engine loop appends.
        self._win_proposed = 0
        self._win_accepted = 0
        self.open = True
        self._plain_rounds = 0

    def rate(self) -> float | None:
        """Acceptance rate over the current window (None = no data)."""
        proposed, accepted = self._win_proposed, self._win_accepted
        if proposed < 1:
            return None
        return min(accepted / proposed, 1.0)

    def observe(self, proposed: int, accepted: int) -> bool:
        """Record one verify round. Returns True exactly when this round
        CLOSED the valve."""
        if not self.open or proposed < 1:
            return False
        if len(self._window) == self.window_rounds:
            old_p, old_a = self._window[0]  # about to fall off
            self._win_proposed -= old_p
            self._win_accepted -= old_a
        self._window.append((proposed, accepted))
        self._win_proposed += proposed
        self._win_accepted += accepted
        if len(self._window) < self.window_rounds:
            return False
        rate = self.rate()
        if rate is not None and rate < self.floor:
            self.open = False
            self._plain_rounds = 0
            self._window.clear()
            self._win_proposed = 0
            self._win_accepted = 0
            return True
        return False

    def tick_plain(self) -> bool:
        """Count one plain round while closed. Returns True exactly when
        the cooldown lapsed and the valve reopened."""
        if self.open:
            return False
        self._plain_rounds += 1
        if self._plain_rounds >= self.reprobe_rounds:
            self.open = True
            return True
        return False
