"""Port serving engine (tiny llama3.2-3b, CPU) against the reference JAX
engine on the same weights: the paper's lifecycle, the hibernation
equivalence property in both wake modes, continuous batching, and equal
tokens, deflate accounting, page ids and REAP working sets.

The reference runs with the features the port does not have yet switched
off (content-addressed store, prefix sharing, pipelined wake, lookahead),
so both take the same path."""
import jax
import numpy as np
import pytest

from repro.core.instance import _path_str
from repro.core.manager import (InstanceManager as JManager,
                                ManagerConfig as JManagerConfig)
from repro.core.state import Rung as JRung
from repro.serving import Request as JRequest, ServingEngine as JEngine
from repro_torch.configs import get_config, tiny_config
from repro_torch.core.manager import InstanceManager, ManagerConfig
from repro_torch.core.state import ContainerState, Rung
from repro_torch.serving import Request, ServingEngine, decode_steps
from repro_torch.weights import params_from_jax

ARCH = "llama3.2-3b"
S = ContainerState
PROMPT1, PROMPT2 = [1, 2, 3, 4, 5], [7, 8]


@pytest.fixture(scope="module")
def port_factory(tiny_factory):
    _, jparams = tiny_factory(ARCH)
    flat = {_path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    cfg = tiny_config(get_config(ARCH))
    return lambda arch_key: (cfg, params_from_jax(flat, device="cpu"))


def _port(factory, spool_dir, wake_mode="reap"):
    mgr = InstanceManager(ManagerConfig(spool_dir=spool_dir,
                                        wake_mode=wake_mode,
                                        pool_capacity_pages=1024,
                                        device="cpu"), factory)
    return ServingEngine(mgr), mgr


def _jax(factory, spool_dir, wake_mode="reap"):
    mgr = JManager(JManagerConfig(spool_dir=spool_dir, wake_mode=wake_mode,
                                  dedup_store=False, prefix_sharing=False,
                                  pipelined_wake=False, lookahead=False),
                   factory)
    return JEngine(mgr), mgr


def _hibernation_run(make, req_cls, rung, factory, spool_dir, wake_mode,
                     hibernate):
    """test_engine.py:59's scenario; returns what both packages expose."""
    eng, mgr = make(factory, spool_dir, wake_mode)
    inst = eng.start_instance("i0", ARCH)

    def req(sid, toks, n, **kw):
        return req_cls("i0", sid, np.asarray(toks, np.int32),
                       max_new_tokens=n, **kw)

    r1 = eng.handle(req("s", PROMPT1, 3))
    st = None
    if hibernate:
        eng.record_sample("i0", req("probe", [9], 2, close_session=True))
        st = mgr.descend("i0", rung)
    r2 = eng.handle(req("s", PROMPT2, 4))
    return {"tokens": (r1.tokens, r2.tokens),
            "states": (r2.state_before, r2.state_after),
            "faults": r2.faults, "prefetched": r2.prefetched_bytes,
            "deflate": None if st is None else
            (st.reap_bytes, st.swap_bytes, st.kv_pages_swapped,
             st.kv_pages_reclaimed),
            "working_set": list(inst.recorder.ordered_working_set),
            "pages": inst.kv.sessions["s"].pages,
            "num_tokens": inst.kv.sessions["s"].num_tokens,
            "used_bytes": mgr.pool.used_bytes,
            "weight_bytes": inst.weight_bytes()}


@pytest.fixture(scope="module")
def reference_runs(tiny_factory, tmp_path_factory):
    """The JAX engine's results, computed once per module (jit-heavy)."""
    d = str(tmp_path_factory.mktemp("jax_spool"))
    out = {mode: _hibernation_run(_jax, JRequest, JRung.HIBERNATED,
                                  tiny_factory, f"{d}/{mode}", mode, True)
           for mode in ("reap", "pagefault")}
    eng, _ = _jax(tiny_factory, f"{d}/batch")
    eng.start_instance("i0", ARCH)
    out["batch"] = [r.tokens for r in eng.serve_batch("i0", _batch(JRequest))]
    return out


def _batch(req_cls):
    return [req_cls("i0", f"s{j}", np.asarray([j + 1, j + 2], np.int32),
                    max_new_tokens=2 + j) for j in range(3)]


def test_lifecycle_states(port_factory, spool_dir):
    eng, mgr = _port(port_factory, spool_dir)
    inst = eng.start_instance("i0", ARCH)
    cfg = inst.cfg
    assert inst.state == S.WARM

    def req(sid, toks, n=4):
        return Request("i0", sid, np.asarray(toks, np.int32), max_new_tokens=n)

    r1 = eng.handle(req("s0", [1, 2, 3]))
    assert (r1.state_before, r1.state_after) == ("warm", "warm")
    assert len(r1.tokens) == 4
    assert all(0 <= t < cfg.vocab_size for t in r1.tokens)
    mgr.descend("i0", Rung.HIBERNATED)
    assert inst.state == S.HIBERNATE
    assert inst.weight_bytes() == 0
    # dropped weights are released, and compute cannot reach them
    assert all(w is None for w in inst.weights.values())
    with pytest.raises(KeyError, match="not resident"):
        inst.params()
    r2 = eng.handle(req("s1", [4, 5], 4))
    assert (r2.state_before, r2.state_after) == ("hibernate", "woken")
    r3 = eng.handle(req("s2", [6]))
    assert (r3.state_before, r3.state_after) == ("woken", "woken")
    with pytest.raises(NotImplementedError):
        mgr.descend("i0", Rung.PARTIAL)


@pytest.mark.parametrize("wake_mode", ["reap", "pagefault"])
def test_hibernation_does_not_change_outputs(wake_mode, port_factory,
                                             spool_dir, reference_runs):
    """THE correctness property, in the port: tokens after a hibernate/
    wake cycle equal a never-slept instance's, and both equal the
    reference engine's, with the same deflate accounting, working set,
    page ids and pool usage."""
    base = _hibernation_run(_port, Request, Rung.HIBERNATED, port_factory,
                            f"{spool_dir}/base", wake_mode, False)
    hib = _hibernation_run(_port, Request, Rung.HIBERNATED, port_factory,
                           f"{spool_dir}/hib", wake_mode, True)
    assert hib["tokens"] == base["tokens"], f"wake ({wake_mode}) changed tokens"
    assert hib["states"] == ("hibernate", "woken")
    ref = reference_runs[wake_mode]
    for key in ("tokens", "deflate", "working_set", "pages", "num_tokens",
                "used_bytes", "weight_bytes", "faults", "prefetched"):
        assert hib[key] == ref[key], key
    # decode writes KV for every step it ran: 5 + 2 steps, then 2 + 3 more
    assert hib["num_tokens"] == 5 + decode_steps([3]) + 2 + decode_steps([4])
    if wake_mode == "reap":
        assert hib["prefetched"] > 0
    else:
        assert hib["faults"] > 0


@pytest.mark.parametrize("wake_mode", ["reap", "pagefault"])
def test_two_hibernation_cycles_keep_outputs(wake_mode, port_factory,
                                             spool_dir):
    """A second deflate rewrites the REAP file (restoring units a
    pagefault-mode cycle never touched) and rewrites swapped pages in
    place; a third turn still matches a tenant that never slept."""
    def run(hibernate):
        eng, mgr = _port(port_factory, f"{spool_dir}/{hibernate}", wake_mode)
        eng.start_instance("i0", ARCH)
        toks = []
        for turn, prompt in enumerate(([1, 2, 3], [4, 5], [6])):
            toks.append(eng.handle(Request(
                "i0", "s", np.asarray(prompt, np.int32), 3)).tokens)
            if hibernate and turn == 0:
                eng.record_sample("i0", Request(
                    "i0", "probe", np.asarray([9], np.int32), 2,
                    close_session=True))
            if hibernate and turn < 2:
                mgr.descend("i0", Rung.HIBERNATED)
        return toks

    assert run(True) == run(False)


def test_continuous_batching(port_factory, spool_dir, reference_runs):
    eng, _ = _port(port_factory, spool_dir)
    eng.start_instance("i0", ARCH)
    resps = eng.serve_batch("i0", _batch(Request))
    for j, r in enumerate(resps):
        assert len(r.tokens) == 2 + j
    assert [r.tokens for r in resps] == reference_runs["batch"]
    eng2, _ = _port(port_factory, spool_dir + "/solo")
    eng2.start_instance("i0", ARCH)
    for req, r in zip(_batch(Request), resps):
        assert eng2.handle(req).tokens == r.tokens


def test_wake_storm_performs_one_inflate(port_factory, spool_dir):
    eng, mgr = _port(port_factory, spool_dir)
    eng.start_instance("i0", ARCH)
    eng.handle(Request("i0", "s", np.asarray([1, 2], np.int32), 2))
    mgr.descend("i0", Rung.HIBERNATED)
    assert mgr.ensure_awake("i0", trigger="sigcont") is not None
    assert mgr.ensure_awake("i0", trigger="sigcont") is None
    assert mgr.states() == {"i0": "woken"}
    assert (mgr.wakes_performed, mgr.wakes_deduped) == (1, 0)
