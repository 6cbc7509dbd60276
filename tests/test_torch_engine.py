"""Serving engine of the PyTorch port vs the JAX engine.

The same weights (passed across as numpy arrays) and the same requests go
through the JAX ``Engine`` and the port's ``Engine(device="cpu")``, on
reduced qwen2-0.5b (dense, GQA) and olmoe-1b-7b (MoE), with whole-prompt
and chunked prefill.  Greedy tokens must be identical, and so must the
host-side stats (TLB hit rate, translation cost, predicted TP comm).  Two
slots per engine and requests of different lengths make slots finish and
be re-claimed while others decode, and (chunked) a slot prefill while
others decode: the cases where the JAX engine relies on dropped
out-of-bounds writes and the port on its explicit write mask.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

torch.set_num_threads(1)

PAGE, MAX_SEQ, MAX_BATCH = 8, 48, 2
STATS = ("decode_steps", "finished", "tlb_hit_rate", "translation_cost_s",
         "predicted_tp_comm_s", "chunked_prefill", "prefill_chunks",
         "sim_tp_comm_s", "sim_comm_steps")


def models(name):
    jcfg = jconfigs.get_config(name).reduced()
    tcfg = tconfigs.get_config(name).reduced()
    jp = jtf.init_lm(jcfg, jax.random.key(0))
    return jcfg, jp, tcfg, from_jax_params(tcfg, jax.tree.map(np.asarray,
                                                              jp))


def requests(mod, vocab):
    # padded prompt lengths 8/16/24 only: few JAX prefill compilations
    rng = np.random.default_rng(0)
    lens, news = (5, 16, 9, 20, 3), (6, 3, 7, 4, 5)
    return [mod.Request(rid=i, prompt=rng.integers(0, vocab, size=(n,))
                        .astype(np.int32), max_new_tokens=m)
            for i, (n, m) in enumerate(zip(lens, news))]


def serve(mod, cfg, params, *, chunked, **kw):
    lm = mod.PagedLM(cfg, params, max_batch=MAX_BATCH, max_seq=MAX_SEQ,
                     page_tokens=PAGE, **kw)
    eng = mod.Engine(lm, chunked_prefill=chunked)
    for r in requests(mod, cfg.vocab):
        eng.submit(r)
    eng.run_to_completion()
    return {r.rid: r.out_tokens for r in eng.finished}, eng.stats()


@pytest.fixture(scope="module", params=["qwen2-0.5b", "olmoe-1b-7b"])
def pair(request):
    return models(request.param)


@pytest.mark.parametrize("chunked", [False, True])
def test_engine_tokens_and_stats_match_jax(pair, chunked):
    jcfg, jp, tcfg, tp = pair
    jtok, jst = serve(jeng, jcfg, jp, chunked=chunked)
    ttok, tst = serve(teng, tcfg, tp, chunked=chunked, device="cpu")
    assert ttok == jtok
    assert len(ttok) == 5 and all(len(t) for t in ttok.values())
    for k in STATS:
        assert tst[k] == jst[k], k


def test_modelled_engine_matches_jax():
    jcfg = jconfigs.get_config("qwen2-0.5b")
    tcfg = tconfigs.get_config("qwen2-0.5b")
    for chunked in (False, True):
        jtok, jst = serve(jeng, jcfg, None, chunked=chunked, modelled=True)
        ttok, tst = serve(teng, tcfg, None, chunked=chunked, modelled=True,
                          device="cpu")
        assert ttok == jtok
        for k in STATS:
            assert tst[k] == jst[k], k


def test_relower_tp_under_faults_matches_jax():
    """The decode TP twin re-lowered around dead links prices the same."""
    from repro.core import fabric as jfab
    from repro_torch.core import fabric as tfab
    jcfg = jconfigs.get_config("qwen2-0.5b")
    tcfg = tconfigs.get_config("qwen2-0.5b")
    jlm = jeng.PagedLM(jcfg, None, max_batch=8, max_seq=64, modelled=True)
    tlm = teng.PagedLM(tcfg, None, max_batch=8, max_seq=64, modelled=True,
                       device="cpu")
    assert tlm.predicted_tp_comm_s == jlm.predicted_tp_comm_s
    for links in ([(0, 1)], [(0, 1), (5, 9)], []):
        jf = jfab.FaultMap.normalized((), links)
        tf = tfab.FaultMap.normalized((), links)
        assert tlm.relower_tp(tf) == jlm.relower_tp(jf)
        assert tlm.predicted_tp_comm_s == jlm.predicted_tp_comm_s
        assert repr(tlm.tp_schedule) == repr(jlm.tp_schedule)


def test_inactive_slot_never_writes_a_reclaimed_page(pair):
    """A freed slot keeps its stale page-table row; once its page belongs
    to a newly admitted request, a decode step must not write into it."""
    _, _, tcfg, tp = pair
    lm = teng.PagedLM(tcfg, tp, max_batch=2, max_seq=MAX_SEQ,
                      page_tokens=PAGE, device="cpu")
    rng = np.random.default_rng(1)
    s0 = lm.claim_slot(4, 2)                   # one page each
    s1 = lm.claim_slot(4, 2)
    p1 = lm.slot_pages[s1][0]
    lm.free_slot(s1)
    lm.free_slot(s0)
    prompt = rng.integers(0, tcfg.vocab, size=(14,)).astype(np.int32)
    s = lm.claim_slot(14, 2)                   # two pages: slot 0 gets p1
    assert s == s0 and p1 in lm.slot_pages[s]
    assert lm.page_table[s1, 0] == p1 and lm.seq_lens[s1] == 0
    first = lm.prefill_slot(s, prompt)
    k_before = lm.k_pool[:, p1].clone()
    v_before = lm.v_pool[:, p1].clone()
    tokens = np.array([first, 0], np.int32)
    active = np.array([True, False])
    lm.decode_batch(tokens, active)
    off = (len(prompt)) % PAGE                 # the one row slot 0 wrote
    keep = [i for i in range(PAGE) if i != off]
    assert torch.equal(lm.k_pool[:, p1, keep], k_before[:, keep])
    assert torch.equal(lm.v_pool[:, p1, keep], v_before[:, keep])
    assert not torch.equal(lm.k_pool[:, p1, off], k_before[:, off])


def test_export_import_round_trip(pair):
    """A slot exported mid-decode and imported into another node (other
    physical pages) decodes on bit for bit."""
    _, _, tcfg, tp = pair
    mk = lambda: teng.PagedLM(tcfg, tp, max_batch=2, max_seq=MAX_SEQ,
                              page_tokens=PAGE, device="cpu")
    a, b = mk(), mk()
    b.claim_slot(20, 4)                        # b's free pages now differ
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, tcfg.vocab, size=(11,)).astype(np.int32)
    sa = a.claim_slot(len(prompt), 12)
    tok = a.prefill_slot(sa, prompt)
    active = np.zeros(2, bool)
    active[sa] = True
    for _ in range(3):
        toks = np.zeros(2, np.int32)
        toks[sa] = tok
        tok = int(a.decode_batch(toks, active)[sa])
    state = a.export_slot(sa)
    assert state.n_pages == -(-int(a.seq_lens[sa]) // PAGE)
    assert state.nbytes == state.n_pages * PAGE * a.bytes_per_token
    sb = b.import_slot(state)
    assert b.slot_pages[sb][:state.n_pages] != a.slot_pages[sa][:
                                                               state.n_pages]
    act_b = np.zeros(2, bool)
    act_b[sb] = True
    tok_a = tok_b = tok
    for _ in range(4):
        ta, tb = np.zeros(2, np.int32), np.zeros(2, np.int32)
        ta[sa], tb[sb] = tok_a, tok_b
        la = a.decode_logits(ta, active)[sa]
        lb = b.decode_logits(tb, act_b)[sb]
        assert torch.equal(la, lb)
        a.seq_lens[sa] += 1
        b.seq_lens[sb] += 1
        tok_a = tok_b = int(torch.argmax(la))


def test_run_to_completion_raises_when_truncated():
    tcfg = tconfigs.get_config("qwen2-0.5b")
    lm = teng.PagedLM(tcfg, None, max_batch=2, max_seq=MAX_SEQ,
                      page_tokens=PAGE, modelled=True, device="cpu")
    eng = teng.Engine(lm)
    for r in requests(teng, tcfg.vocab):
        eng.submit(r)
    with pytest.raises(teng.TruncatedRunError) as e:
        eng.run_to_completion(max_steps=3)
    assert e.value.steps == 3 and e.value.in_flight == eng.load > 0
