"""Serving engine: request execution over hibernatable model instances
(the port's ``repro/serving/engine.py`` for the dense family).

The engine executes requests (per-request prefill, then a joint decode
over the batch), drives the container state machine, performs residency
faulting (before compute touches a weight unit or KV page, any
non-resident unit is loaded from the swap files) and feeds the REAP
recorder with the exact unit set a request touches, in the reference's
order, so working sets, swap traffic and page ids match the reference.

One deliberate difference: the reference copies the sessions' pages into
a dense cache for decode and writes the new tokens back afterwards.  Here
decode reads KV through the ``paged_attention`` kernel on the pool's own
layout and writes each step's K/V into the pool in place.  The pages the
decode writes are allocated before the loop, in the order the reference's
write-back allocates them.  PyTorch runs eagerly, so there is no per-
instance compile cache.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.instance import ModelInstance
from repro_torch.core.manager import InstanceManager
from repro_torch.core.metrics import LatencyTrace
from repro_torch.core.state import ContainerState, Event
from repro_torch.models import model
from repro_torch.serving.paged_kv import PagedKVCache

S = ContainerState


@dataclass
class Request:
    instance_id: str
    session_id: str
    prompt: np.ndarray                       # (S,) int32 token ids
    max_new_tokens: int = 8
    close_session: bool = False


@dataclass
class Response:
    request: Request
    tokens: List[int] = field(default_factory=list)
    state_before: str = ""
    state_after: str = ""
    #: "ttft" (batch start to this request's first token) and "e2e"
    spans: Dict[str, float] = field(default_factory=dict)
    faulted_bytes: int = 0
    faults: int = 0
    prefetched_bytes: int = 0


def decode_steps(max_new_tokens: Sequence[int]) -> int:
    """Steps the joint decode runs for a batch: the first token comes from
    prefill and the loop stops once every request has its tokens, but it
    always runs at least one step."""
    return max(1, max(max_new_tokens) - 1)


class ServingEngine:
    def __init__(self, manager: InstanceManager):
        self.manager = manager
        self.trace = LatencyTrace()
        self._locks: Dict[str, threading.RLock] = {}
        self._locks_guard = threading.Lock()

    def instance_lock(self, instance_id: str) -> threading.RLock:
        """Per-instance serve lock, held for the whole of ``serve_batch``."""
        with self._locks_guard:
            lock = self._locks.get(instance_id)
            if lock is None:
                lock = self._locks[instance_id] = threading.RLock()
            return lock

    # ------------------------------------------------------------ lifecycle
    def start_instance(self, instance_id: str, arch_key: str
                       ) -> ModelInstance:
        """Cold start (①): build the weights and attach the paged cache."""
        with self.trace.span("cold_start"):
            inst = self.manager.cold_start(instance_id, arch_key)
            inst.kv = PagedKVCache(instance_id, inst.cfg, self.manager.pool)
        return inst

    # ------------------------------------------------------------ weights
    def _static_weight_keys(self, inst: ModelInstance,
                            tokens: np.ndarray) -> List[Tuple]:
        """Units knowable before execution: every leaf, plus the embedding
        blocks of the tokens (all of them with tied embeddings, since the
        LM head reads the whole table every step)."""
        eb = inst.embed_block
        blocks = {int(t) // eb for t in np.asarray(tokens).ravel()}
        all_embed = inst.cfg.tie_embeddings
        return [u.key for u in inst.units.values()
                if not (u.path == "embed" and u.sub >= 0)
                or all_embed or u.sub in blocks]

    def _embed_keys(self, inst: ModelInstance, tokens) -> List[Tuple]:
        """Embedding blocks for a set of token ids."""
        eb = inst.embed_block
        blocks = {int(t) // eb for t in np.asarray(tokens).ravel()}
        return [u.key for u in inst.units.values()
                if u.path == "embed" and u.sub in blocks]

    def _fault(self, inst: ModelInstance, keys: Sequence[Tuple],
               resp: Response) -> None:
        missing = [k for k in keys if k[0] == "w" and k not in inst.resident]
        kv_missing = inst.kv.nonresident_keys([k for k in keys
                                               if k[0] == "kv"])
        if not missing and not kv_missing:
            return
        st = self.manager.hib.fault(inst, missing + kv_missing)
        resp.faulted_bytes += st.faulted_bytes
        resp.faults += st.faults
        inst.recorder.record_many(missing + kv_missing)

    # ------------------------------------------------------------ serving
    def handle(self, req: Request) -> Response:
        return self.serve_batch(req.instance_id, [req])[0]

    def serve_batch(self, instance_id: str,
                    reqs: List[Request]) -> List[Response]:
        """Per-request prefill, then a joint decode loop that sessions
        leave as they finish."""
        with self.instance_lock(instance_id):
            return self._serve_batch_locked(instance_id, reqs)

    def _serve_batch_locked(self, instance_id: str,
                            reqs: List[Request]) -> List[Response]:
        inst = self.manager.instances.get(instance_id)
        if inst is None:
            raise KeyError(f"instance {instance_id} not started")
        resps = [Response(r, state_before=inst.state.value) for r in reqs]
        t0 = time.monotonic()

        wake_stats = None
        if inst.state in (S.HIBERNATE, S.WOKEN):
            if inst.state == S.HIBERNATE:
                wake_stats = self.manager.ensure_awake(instance_id,
                                                       trigger="request")
            inst.sm.fire(Event.REQUEST)       # -> HIBERNATE_RUNNING
            finish_to = S.WOKEN
        elif inst.state == S.WARM:
            inst.sm.fire(Event.REQUEST)       # -> RUNNING
            finish_to = S.WARM
        else:
            raise RuntimeError(f"instance busy/unservable: {inst.state}")
        if wake_stats is not None:
            for r in resps:
                r.prefetched_bytes = wake_stats.prefetched_bytes

        for req, resp in zip(reqs, resps):
            with self.trace.span("prefill"):
                self._prefill_one(inst, req, resp)
            resp.spans["ttft"] = time.monotonic() - t0
        if any(r.max_new_tokens > 0 for r in reqs):
            with self.trace.span("decode"):
                self._decode_joint(inst, reqs, resps,
                                   [r.session_id for r in reqs])

        inst.sm.fire(Event.FINISH)
        if inst.state != finish_to:
            raise RuntimeError(f"finished in {inst.state}, not {finish_to}")
        for req in reqs:
            if req.close_session:
                inst.kv.close_session(req.session_id)
        for r in resps:
            r.state_after = inst.state.value
            r.spans["e2e"] = time.monotonic() - t0
        return resps

    def _prefill_one(self, inst: ModelInstance, req: Request,
                     resp: Response) -> None:
        """Prefill one prompt.  Like the reference, a continuing session's
        prompt is run on its own, with positions from 0, and its K/V are
        appended after the session's earlier tokens."""
        cfg, kv = inst.cfg, inst.kv
        if req.session_id not in kv.sessions:
            kv.new_session(req.session_id)
        sess = kv.sessions[req.session_id]

        static_keys = self._static_weight_keys(inst, req.prompt)
        self._fault(inst, static_keys, resp)
        inst.recorder.record_many(k for k in static_keys if k[0] == "w")
        if sess.num_tokens:
            prior = kv.keys_for(req.session_id)
            self._fault(inst, prior, resp)
            inst.recorder.record_many(prior)

        dev = kv.pool.device
        tokens = torch.as_tensor(np.asarray(req.prompt, np.int64),
                                 device=dev)[None]
        params = inst.params()
        x, caches = model.forward_hidden(params, cfg, tokens,
                                         collect_cache=True)
        logits = model.unembed(params, cfg, x[:, -1])
        resp.tokens.append(int(torch.argmax(logits[0, :cfg.vocab_size])))

        n0, n = sess.num_tokens, tokens.shape[1]
        touched: List[Tuple] = []
        for layer in range(cfg.num_layers):
            new = torch.stack([caches["k"][layer, 0], caches["v"][layer, 0]], 1)
            touched += kv.write_tokens(req.session_id, layer,
                                       new.reshape(n, kv.token_elems), n0)
        sess.num_tokens = n0 + n
        inst.recorder.record_many(touched)

    def _decode_joint(self, inst: ModelInstance, reqs: List[Request],
                      resps: List[Response], sids: List[str]) -> None:
        cfg, kv = inst.cfg, inst.kv
        L = cfg.num_layers
        for sid in sids:                      # every page decode will read
            self._fault(inst, kv.keys_for(sid), resps[0])
            inst.recorder.record_many(kv.keys_for(sid))
        n_steps = decode_steps([r.max_new_tokens for r in reqs])
        start = [kv.sessions[s].num_tokens for s in sids]

        # pages for every step's K/V, allocated in the reference's
        # write-back order (session-major, then layer), so page ids match
        touched: List[Tuple] = []
        for b, sid in enumerate(sids):
            for layer in range(L):
                touched += kv.reserve_tokens(sid, layer, start[b], n_steps)
        dev = kv.pool.device
        tables = torch.from_numpy(np.stack(
            [kv.page_table(sids, layer) for layer in range(L)])).to(dev)
        slots = torch.from_numpy(np.stack(
            [np.stack([kv.token_offsets(sid, layer, start[b], n_steps)
                       for b, sid in enumerate(sids)], 1)
             for layer in range(L)], 1)).to(dev)        # (steps, L, B)
        lengths = (torch.tensor(start, dtype=torch.int32)[None]
                   + torch.arange(1, n_steps + 1, dtype=torch.int32)[:, None]
                   ).to(dev)                             # (steps, B)

        cur = np.asarray([r.tokens[-1] for r in resps], np.int64)
        for step in range(n_steps):
            # the fed-back tokens' embedding rows fault on access
            ek = self._embed_keys(inst, cur)
            inst.recorder.record_many(ek)
            self._fault(inst, ek, resps[0])
            logits = model.decode_step(
                inst.params(), cfg, torch.from_numpy(cur).to(dev), kv.pool.data,
                tables, slots[step], lengths[step],
                page_tokens=kv.page_tokens)
            nxt = torch.argmax(logits[:, :cfg.vocab_size], -1).cpu().numpy()
            for b, r in enumerate(resps):       # finished rows keep decoding
                if len(r.tokens) < r.request.max_new_tokens:
                    r.tokens.append(int(nxt[b]))
            cur = nxt.astype(np.int64)
        for b, sid in enumerate(sids):
            kv.sessions[sid].num_tokens = start[b] + n_steps
        inst.recorder.record_many(touched)

    # ------------------------------------------------------------ REAP ops
    def record_sample(self, instance_id: str, req: Request) -> frozenset:
        """§3.4.2 Record process: run a sample request with the recorder
        on; the union of touched units becomes the REAP working set."""
        inst = self.manager.instances[instance_id]
        inst.recorder.start()
        self.handle(req)
        return inst.recorder.stop()
