"""The port's serving engine on the CPU: the five tests of
``tests/test_serving.py`` against the port, and the port's tokens against
the reference ``Engine``'s for the same requests on the same weights
(float32, ``qwen2-1.5b`` reduced, ``PRNGKey(0)``).

The reference decodes every slot at one shared position (ROADMAP Queue 3);
the port keeps that, and the last test shows it: a 3-token request decoded
beside a 20-token one gets the reference's logits there, which differ
from its logits when served alone.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import transformer as RT
from repro.models.params import unbox
from repro.serving.server import Engine as RefEngine
from repro.serving.server import Request as RefRequest
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.serving.graph_frontend import FakeClock
from repro_torch.serving.server import Engine, Request
from repro_torch.train.steps import make_decode_step, make_prefill_step


@pytest.fixture(scope="module")
def setup():
    ref_cfg = ref_get_config("qwen2-1.5b").reduced()
    cfg = get_config("qwen2-1.5b").reduced()
    params = jax.jit(lambda key: unbox(RT.init_params(key, ref_cfg))[0])(jax.random.PRNGKey(0))
    model = lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")
    return cfg, model, ref_cfg, params


def test_engine_serves_all_requests(setup):
    cfg, params, _, _ = setup
    eng = Engine(cfg, params, slots=2, max_len=64)
    rng = np.random.default_rng(1)
    for rid in range(5):
        eng.submit(Request(rid=rid, prompt=rng.integers(0, cfg.vocab_size, 9).astype(np.int32), max_new=4))
    done = eng.run_until_drained()
    assert len(done) == 5
    assert all(len(r.out) == 4 for r in done)
    assert all(r.t_first > 0 and r.t_done >= r.t_first for r in done)


def test_engine_greedy_matches_manual_decode(setup):
    """A request served through slot-spliced continuous batching gives the
    greedy tokens of a dedicated prefill + decode loop."""
    cfg, params, _, _ = setup
    prompt = np.asarray([5, 9, 2, 7, 11, 3], dtype=np.int32)

    prefill = make_prefill_step(cfg, max_len=64)
    decode = make_decode_step(cfg)
    logits, st = prefill(params, {"tokens": torch.from_numpy(prompt[None, :])})
    ref = [int(torch.argmax(logits[0]))]
    tok = torch.tensor([[ref[-1]]], dtype=torch.int32)
    for _ in range(3):
        lg, nxt, st = decode(params, st, tok)
        ref.append(int(nxt[0]))
        tok = nxt[:, None]

    eng = Engine(cfg, params, slots=2, max_len=64)
    eng.submit(Request(rid=0, prompt=prompt, max_new=4))
    done = eng.run_until_drained()
    assert done[0].out == ref, (done[0].out, ref)


def test_engine_latency_fields_come_from_injected_clock(setup):
    cfg, params, _, _ = setup
    clk = FakeClock(start=100.0)
    eng = Engine(cfg, params, slots=1, max_len=64, clock=clk)
    eng.submit(Request(rid=0, prompt=np.asarray([1, 2, 3], np.int32), max_new=4))
    clk.advance(5.0)
    (r,) = eng.run_until_drained()
    assert r.t_submit == 100.0
    assert r.t_first == 105.0 and r.t_done == 105.0
    assert r.t_done - r.t_submit == 5.0


def test_engine_default_clock_is_monotonic(setup):
    cfg, params, _, _ = setup
    eng = Engine(cfg, params, slots=1, max_len=64)
    a = eng.clock.now()
    b = eng.clock.now()
    assert b >= a


def test_engine_two_slots_do_not_interfere(setup):
    """The longer request's tokens are the same alone and beside a shorter
    one (what the reference's test checks; the shorter one is the last
    test's subject)."""
    cfg, params, _, _ = setup
    p1 = np.asarray([5, 9, 2, 7, 11, 3], dtype=np.int32)
    p2 = np.asarray([100, 200, 300], dtype=np.int32)

    eng_a = Engine(cfg, params, slots=2, max_len=64)
    eng_a.submit(Request(rid=0, prompt=p1, max_new=4))
    alone = {r.rid: r.out for r in eng_a.run_until_drained()}

    eng_b = Engine(cfg, params, slots=2, max_len=64)
    eng_b.submit(Request(rid=0, prompt=p1, max_new=4))
    eng_b.submit(Request(rid=1, prompt=p2, max_new=4))
    both = {r.rid: r.out for r in eng_b.run_until_drained()}
    assert both[0] == alone[0], (both[0], alone[0])


def test_engine_tokens_equal_the_reference_engine(setup):
    """Five requests of three prompt lengths over two slots, with slot
    refills: every request's tokens equal the reference engine's."""
    cfg, params, ref_cfg, ref_params = setup
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (9, 5, 9, 12, 5)]
    ref = RefEngine(ref_cfg, ref_params, slots=2, max_len=64)
    eng = Engine(cfg, params, slots=2, max_len=64)
    for rid, p in enumerate(prompts):
        ref.submit(RefRequest(rid=rid, prompt=p, max_new=5))
        eng.submit(Request(rid=rid, prompt=p, max_new=5))
    want = {r.rid: r.out for r in ref.run_until_drained()}
    got = {r.rid: r.out for r in eng.run_until_drained()}
    assert got == want
    assert eng.state.index == int(ref.state.index)


def _first_decode_logits(make, params, prompts, slot, to_tokens):
    """The logits of ``slot``'s first decode step after every prompt is
    admitted into an engine of 2 slots and 64 positions."""
    eng = make(params)
    for rid, p in enumerate(prompts):
        eng.submit((Request if isinstance(eng, Engine) else RefRequest)(rid=rid, prompt=p))
    eng._admit()
    logits, _, _ = eng._decode(eng.params, eng.state, to_tokens(eng.last_tok))
    return np.asarray(logits[slot], dtype=np.float32)


def test_shared_decode_index_reproduces_the_reference(setup):
    """Request B (3 tokens) decoded beside A (20 tokens) is decoded at A's
    position, as in the reference: the port's logits for B equal the
    reference engine's there, and both differ from B served alone."""
    cfg, params, ref_cfg, ref_params = setup
    a = (np.arange(1, 21) * 7 % 500).astype(np.int32)
    b = np.asarray([100, 200, 300], np.int32)

    def port(p):
        return Engine(cfg, p, slots=2, max_len=64)

    def ref(p):
        return RefEngine(ref_cfg, p, slots=2, max_len=64)

    port_beside = _first_decode_logits(port, params, [a, b], 1, torch.from_numpy)
    ref_beside = _first_decode_logits(ref, ref_params, [a, b], 1, jnp.asarray)
    port_alone = _first_decode_logits(port, params, [b], 0, torch.from_numpy)
    ref_alone = _first_decode_logits(ref, ref_params, [b], 0, jnp.asarray)
    tol = 1e-4 * float(np.abs(ref_beside).max())
    np.testing.assert_allclose(port_beside, ref_beside, atol=tol, rtol=0)
    np.testing.assert_allclose(port_alone, ref_alone, atol=tol, rtol=0)
    # the fault itself: beside A, B's logits are not its logits alone
    assert float(np.abs(ref_beside - ref_alone).max()) > 1.0
    assert float(np.abs(port_beside - port_alone).max()) > 1.0
