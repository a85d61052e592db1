"""Continuously batched LM engine (port of `repro.serve.lm.engine`, the
third `StreamEngine` client).

`serve/engine.generate` serves one batch of prompts at a time.  `LMEngine`
keeps a fixed set of decode *lanes* — rows of one engine-wide KV cache /
recurrent state — and runs ONE `decode_step` per tick across every active
lane, at heterogeneous positions (the vector-`pos` form of
`models/layers.attn_decode`; recurrent blocks ignore the positions):

    requests ──submit(prompt, max_new)──▶ LMQueue (FIFO)
                                            │ admit: free lane?
                                            ▼
                B=1 exact-length prefill ─▶ copy into lane's cache row
                (fresh per-admission cache; argmax = first token, TTFT)
                                            │
          every tick ──▶ ONE decode_step(tokens (L,1), cache, pos (L,))
                                            │ argmax per lane
                                            ▼
            finished lanes evict ──▶ futures resolve (prompt + tokens)

Scheduling invariants (the reference's):

  * admission is continuous — a request admits the moment a lane frees,
    mid-decode of the others; nothing waits for the batch to drain;
  * eviction is immediate — a lane frees the tick its request emits its
    last token, so the next queued request admits on the following tick;
  * per-token parity — each sequence's token stream is what the
    sequential `generate` loop produces (greedy argmax; the prefill writes
    the same ring/global slots, the lane copy inserts the whole
    per-sequence cache, and vector-`pos` decode equals scalar decode row
    by row), regardless of what shares the batch.  On the CPU this holds
    token for token; on the card a GEMM may split a row's sum differently
    at another batch size, so a lane's logits are held to the B = 1 path
    within a bf16 tolerance instead (`chip_smoke.py`'s `lm` phase);
  * dirty lanes are safe — admission overwrites the lane's entire cache
    row (its K/V and its recurrent states), so whatever the previous
    occupant left is unreachable.

Decoding is greedy only.  Serving params are frozen, so the engine casts
the product weights to the compute dtype once, at construction
(`transformer.serving_params`): bitwise the logits of casting at every use.
Observability runs through the shared `StreamEngine` wiring, phase "lm",
with the reference's `stats()` keys and span names (`serve_lm.admit`,
`serve_lm.launch`, `serve_lm.block_until_ready`, `serve_lm.reply`,
per-request `serve_lm.request`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch import tree
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import ATTN_GLOBAL, ModelConfig
from repro_torch.obs import Observability
from repro_torch.runtime.engine import BatcherConfig, RequestFuture, StreamEngine
from repro_torch.runtime.engine.queue import CoalescingQueue

Params = dict[str, Any]


@dataclasses.dataclass
class LMRequest:
    """One queued generation request (whole-sequence; no streaming)."""

    prompt: np.ndarray  # (S,) int32 token ids
    max_new: int
    future: RequestFuture
    t_submit: float  # perf_counter at enqueue


class LMQueue(CoalescingQueue):
    """FIFO queue of generation requests.  Drained via `pop` (admission),
    never `next_batch` — continuous batching has no coalesce window."""

    def submit(self, prompt, max_new: int) -> RequestFuture:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        req = LMRequest(prompt=prompt, max_new=int(max_new), future=RequestFuture(), t_submit=time.perf_counter())
        self._enqueue(req)
        return req.future


@dataclasses.dataclass
class _Lane:
    """One active decode lane: the request it serves + emission state."""

    req: LMRequest
    tokens: list  # emitted token ids (ints)
    remaining: int  # decode steps left after the tokens already emitted


def _insert_lane(big: Params, small: Params, lane: int) -> Params:
    """Copy a B=1 cache tree into row `lane` of the engine cache, in place.

    `init_cache` leaves are batch-first: stacked leaves carry the period
    axis first ((P, B, ...) — batch at axis 1), tail leaves start at batch
    (axis 0).  The whole row — every leaf, K/V and recurrent states alike —
    is overwritten, which is what makes dirty-lane reuse safe."""
    for b, s in zip(big["scan"], small["scan"]):
        for name in b:
            b[name][:, lane] = s[name][:, 0].to(b[name].dtype)
    for b, s in zip(big["tail"], small["tail"]):
        for name in b:
            b[name][lane] = s[name][0].to(b[name].dtype)
    return big


class LMEngine(StreamEngine):
    """Decodes many LM requests concurrently over fixed cache lanes.

    Synchronous use: `generate_batch(prompts, max_new)` — deterministic
    admit/decode/evict ticks on the caller's thread.  Threaded use:
    `start()`, then `submit(prompt, max_new).result()` from any number of
    client threads; `stop()` drains both the queue and the in-flight lanes.
    `device=` is where the params and caches live: the card unless the
    caller passes "cpu".
    """

    not_running_msg = "LM engine not serving; call start() first (or use generate_batch for synchronous runs)"
    already_started_msg = "LM engine already started"
    stopped_msg = "LM engine stopped before serving this request"
    health_running_key = "serving"
    thread_name = "lm-serve"

    def __init__(
        self,
        params: Params,
        cfg: ModelConfig,
        *,
        lanes: int = 4,
        max_seq: int = 256,
        obs: Optional[Observability] = None,
        rules=None,
        device: DeviceLike = None,
    ):
        if lanes < 1:
            raise ValueError(f"lanes must be >= 1, got {lanes}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.rules = rules
        self.params = T.serving_params(tree.tree_map(lambda t: t.to(self.device), params), cfg)
        self.lanes = int(lanes)
        self.max_seq = int(max_seq)
        self._has_global = ATTN_GLOBAL in cfg.block_pattern
        # host-side lane state: token fed to the next decode step + its
        # position, per lane (inactive lanes decode garbage at pos 0 —
        # their rows are overwritten wholesale at the next admission)
        self._cache = T.init_cache(cfg, self.lanes, self.max_seq, device=self.device)
        self._tokens = np.zeros((self.lanes, 1), np.int32)
        self._pos = np.zeros((self.lanes,), np.int64)
        self._active: dict[int, _Lane] = {}
        obs = obs if obs is not None else Observability()
        reg = obs.registry
        self._m_prefills = reg.counter("serve_lm.prefills")
        self._m_prefill_s = reg.counter("serve_lm.prefill_s")
        self._m_evictions = reg.counter("serve_lm.evictions")
        self._m_ttft = reg.histogram("serve_lm.ttft_s")
        super().__init__(
            prefix="serve_lm",
            phase="lm",
            items_name="tokens",
            calls_name="decode_steps",
            queue=LMQueue(BatcherConfig(buckets=(self.lanes,), max_wait_ms=0.0), registry=reg,
                          prefix="serve_lm.batcher"),
            modes=("prefill", "decode"),
            force_mode="decode",  # decode steps are the metered calls
            obs=obs,
            audit=False,  # no cost-model axis for LM decode (single mode)
        )

    # device calls: the engine's two model functions, over its own params
    # and rules (tests and chip_smoke.py wrap these to read the logits)

    def _prefill(self, tokens: torch.Tensor, cache: Params):
        return T.prefill(self.params, {"tokens": tokens}, self.cfg, rules=self.rules, cache=cache)

    def _decode(self, tokens: torch.Tensor, cache: Params, pos: torch.Tensor):
        return T.decode_step(self.params, tokens, cache, pos, self.cfg, rules=self.rules)

    # ------------------------------------------------------------------ #
    # public API
    # ------------------------------------------------------------------ #

    def submit(self, prompt, max_new: int) -> RequestFuture:
        """Enqueue one generation request; `.result()` resolves to the
        full sequence (prompt + generated tokens) as a (S + n,) int32
        array once the lane finishes."""
        self._require_running()
        return self._batcher.submit(prompt, max_new)

    def generate_batch(self, prompts: Sequence, max_new) -> list:
        """Synchronously serve a batch of prompts through the continuous
        scheduler on the caller's thread: enqueue everything, then tick
        (admit + one decode step) until all lanes drain.  Deterministic —
        the tick sequence depends only on (prompts, max_new, lanes)."""
        if self._thread is not None:
            raise RuntimeError("generate_batch requires a stopped engine (the serve thread owns ticks)")
        if isinstance(max_new, int):
            max_new = [max_new] * len(prompts)
        if len(max_new) != len(prompts):
            raise ValueError(f"{len(prompts)} prompts but {len(max_new)} max_new values")
        self._batcher.reopen()  # a previous stop() leaves the queue closed
        futs = [self._batcher.submit(p, n) for p, n in zip(prompts, max_new)]
        while self._pending():
            self._tick(0.0)
        return [np.asarray(f.result(timeout=0)) for f in futs]

    # ------------------------------------------------------------------ #
    # continuous-batching tick (replaces the coalescing default)
    # ------------------------------------------------------------------ #

    def _pending(self) -> int:
        return len(self._batcher) + len(self._active)

    def _tick(self, timeout: float) -> None:
        """One scheduling step: admit into free lanes, then one decode
        step across all active lanes.  Blocks (up to `timeout`) only when
        fully idle — with lanes in flight the decode must not wait."""
        free = [i for i in range(self.lanes) if i not in self._active]
        if free:
            reqs = self._batcher.pop(len(free), timeout=timeout if not self._active else None)
            for lane, req in zip(free, reqs):
                self._admit(lane, req)
        if self._active:
            self._decode_once()

    @torch.inference_mode()
    def _admit(self, lane: int, req: LMRequest) -> None:
        """Prefill the prompt at exact length (B=1) and copy the resulting
        cache into the lane row; the prefill's argmax is the request's
        first generated token (TTFT point)."""
        tracer = self.obs.tracer
        s = req.prompt.shape[0]
        try:
            if self._has_global and s + req.max_new > self.max_seq:
                raise ValueError(
                    f"prompt of {s} tokens + max_new {req.max_new} exceeds "
                    f"the engine's KV cache length {self.max_seq} "
                    f"(global-attention arch {self.cfg.name!r})"
                )
            with tracer.span("serve_lm.admit", lane=lane, prompt_len=s):
                t0 = time.perf_counter()
                small = T.init_cache(self.cfg, 1, self.max_seq, device=self.device)
                tokens = torch.from_numpy(req.prompt[None]).to(self.device)
                logits, small = self._prefill(tokens, small)
                _insert_lane(self._cache, small, lane)
                tok = int(torch.argmax(logits[0], -1))  # reads the result: a device sync
                dt = time.perf_counter() - t0
        except BaseException as err:  # noqa: BLE001 — fail this request only
            req.future.set_exception(err)
            return
        self._m_prefills.inc()
        self._m_prefill_s.inc(dt)
        self._m_ttft.observe(time.perf_counter() - req.t_submit)
        self._tokens[lane, 0] = tok
        self._pos[lane] = s
        self._active[lane] = _Lane(req=req, tokens=[tok], remaining=req.max_new - 1)
        if self._active[lane].remaining == 0:
            self._evict([lane])

    @torch.inference_mode()
    def _decode_once(self) -> None:
        """ONE device call decodes every active lane at its own position;
        inactive lanes ride along as padding rows."""
        tracer = self.obs.tracer
        active = sorted(self._active)
        t0 = time.perf_counter()
        try:
            with tracer.span("serve_lm.launch", lanes=len(active)):
                tokens = torch.from_numpy(self._tokens).to(self.device)
                pos = torch.from_numpy(self._pos).to(self.device)
                logits, _ = self._decode(tokens, self._cache, pos)
                toks_dev = torch.argmax(logits[:, -1], -1)
            with tracer.span("serve_lm.block_until_ready", lanes=len(active)):
                toks = toks_dev.cpu().numpy()
        except BaseException as err:  # noqa: BLE001 — relay to active lanes
            for lane in active:
                self._active.pop(lane).req.future.set_exception(err)
            return
        # qat-probe cadence is ignored: the LM serve path is frozen-params
        self._finish_call(len(active), self.lanes, "decode", time.perf_counter() - t0)
        done = []
        for lane in active:
            st = self._active[lane]
            st.tokens.append(int(toks[lane]))
            st.remaining -= 1
            self._tokens[lane, 0] = int(toks[lane])
            self._pos[lane] += 1
            if st.remaining == 0:
                done.append(lane)
        if done:
            self._evict(done)

    def _evict(self, lanes: Sequence[int]) -> None:
        """Free finished lanes and resolve their futures (the shared
        `_reply` records latency metrics + request spans)."""
        states = [self._active.pop(lane) for lane in lanes]
        self._m_evictions.inc(len(states))
        self._reply(
            [st.req for st in states],
            [np.concatenate([st.req.prompt, np.asarray(st.tokens, np.int32)]) for st in states],
        )

    # ------------------------------------------------------------------ #
    # metrics
    # ------------------------------------------------------------------ #

    def stats(self) -> dict:
        """Serving metrics so far: decode throughput + occupancy off the
        shared registry, TTFT quantiles off the admission histogram."""
        m = self._metrics
        device_s = m.device_s
        wall = m.wall_s()
        prefills = self._m_prefills.value
        tokens = m.items + prefills  # decoded tokens + one per prefill
        ttft = self._m_ttft
        return {
            "requests": m.requests,
            "admitted": prefills,
            "evicted": self._m_evictions.value,
            "tokens": tokens,
            "decode_steps": m.calls,
            "tokens_per_s_device": (
                tokens / (device_s + self._m_prefill_s.value) if device_s + self._m_prefill_s.value > 0 else None
            ),
            "tokens_per_s_wall": (tokens / wall if wall else None),
            "ttft_p50_ms": (ttft.quantile(0.50) or 0) * 1e3 if ttft.count else None,
            "ttft_p99_ms": (ttft.quantile(0.99) or 0) * 1e3 if ttft.count else None,
            "p50_ms": m.latency_ms(0.50),
            "p99_ms": m.latency_ms(0.99),
            "decode_occupancy": m.occupancy(),
            "lanes": self.lanes,
            "mode_histogram": m.mode_histogram(),
        }

    def reset_stats(self) -> None:
        super().reset_stats()
        for c in (self._m_prefills, self._m_prefill_s, self._m_evictions):
            c.reset()
        self._m_ttft.reset()


__all__ = ["LMEngine", "LMQueue", "LMRequest"]
