"""The port's wire codec, frames and session-store eviction policies,
mirroring the reference suite's ``tests/test_wire.py`` on
:mod:`repro_torch.amg.api` and :mod:`repro_torch.serve.wire`.

The codec is the service's outer wall: every payload is schema-versioned,
unknown keys are rejected, CSR matrices travel with a content fingerprint
that the decoder re-verifies, and every registered backend's config
survives dict ↔ wire ↔ dict unchanged.  Schema v2 adds streaming
``update_request`` payloads and the nested ``options`` dict on solve
requests; v1 frames must keep decoding on a v2 stack.

Against the reference: for the same object, the port's payloads and its
``encode_frame`` bytes equal the reference's byte for byte, so a client of
either server speaks to both; the frame limit is the reference's, and an
oversized frame is drained with the stream left aligned.
"""
import asyncio
import base64
import json
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.amg.api import (AMGConfig, BytesBudgetPolicy, LRUPolicy,  # noqa: E402
                                 RequestOptions, SUPPORTED_SCHEMAS,
                                 SessionStore, TTLPolicy, WIRE_SCHEMA,
                                 WireError, array_from_wire, array_to_wire,
                                 available_backends, csr_from_wire,
                                 csr_to_wire, matrix_fingerprint,
                                 solve_request_from_wire,
                                 solve_request_to_wire,
                                 update_request_from_wire,
                                 update_request_to_wire)
from repro_torch.amg.csr import CSR  # noqa: E402
from repro_torch.amg.problems import laplace_3d  # noqa: E402
from repro_torch.amg.solve import SolveOptions  # noqa: E402


# ----------------------------------------------------------------- schema
def test_schema_version_mismatch_rejected():
    cfg = AMGConfig()
    for payload in (cfg.to_wire(), csr_to_wire(laplace_3d(4)),
                    solve_request_to_wire("m", np.ones(4))):
        bad = {**payload, "schema": WIRE_SCHEMA + 1}
        with pytest.raises(WireError, match="schema version mismatch"):
            (AMGConfig.from_wire if payload["kind"] == "amg_config" else
             csr_from_wire if payload["kind"] == "csr" else
             solve_request_from_wire)(bad)
        missing = dict(payload)
        del missing["schema"]
        with pytest.raises(WireError, match="schema version mismatch"):
            (AMGConfig.from_wire if payload["kind"] == "amg_config" else
             csr_from_wire if payload["kind"] == "csr" else
             solve_request_from_wire)(missing)


def test_wrong_kind_rejected():
    with pytest.raises(WireError, match="expected a 'csr' payload"):
        csr_from_wire(AMGConfig().to_wire())
    with pytest.raises(WireError, match="expected a 'amg_config'"):
        AMGConfig.from_wire(solve_request_to_wire("m", np.ones(3)))


# ------------------------------------------------------------ unknown keys
def test_unknown_key_rejection():
    cfg = AMGConfig()
    with pytest.raises(WireError, match="unknown key.*future_knob"):
        AMGConfig.from_wire({**cfg.to_wire(), "future_knob": 1})
    opts_payload = cfg.to_wire()
    opts_payload["opts"] = {**opts_payload["opts"], "sor_omega": 1.5}
    with pytest.raises(WireError, match="opts has unknown key.*sor_omega"):
        AMGConfig.from_wire(opts_payload)
    with pytest.raises(WireError, match="opts must be a dict"):
        AMGConfig.from_wire({**cfg.to_wire(), "opts": "jacobi"})
    with pytest.raises(WireError, match="unknown key"):
        csr_from_wire({**csr_to_wire(laplace_3d(4)), "colors": "red"})
    with pytest.raises(WireError, match="unknown key"):
        solve_request_from_wire({**solve_request_to_wire("m", np.ones(3)),
                                 "retries": 3})
    with pytest.raises(WireError, match="unknown key"):
        array_from_wire({**array_to_wire(np.ones(3)), "stride": 8})


# ------------------------------------------------------------- csr payloads
def _assert_csr_equal(A, B):
    assert A.shape == B.shape
    np.testing.assert_array_equal(A.indptr, B.indptr)
    np.testing.assert_array_equal(A.indices, B.indices)
    np.testing.assert_array_equal(A.data, B.data)


def test_csr_round_trip_through_json():
    A = laplace_3d(5)
    payload = json.loads(json.dumps(csr_to_wire(A)))   # a real byte hop
    B, fp = csr_from_wire(payload)
    _assert_csr_equal(A, B)
    assert fp == matrix_fingerprint(A) == payload["fingerprint"]


def test_csr_round_trip_empty_and_non_square():
    empty = CSR.from_coo([], [], [], (5, 5))
    B, _ = csr_from_wire(csr_to_wire(empty))
    _assert_csr_equal(empty, B)
    assert B.nnz == 0
    rect = CSR.from_coo([0, 1, 2], [6, 0, 3], [1.0, -2.0, 0.5], (3, 7))
    B, _ = csr_from_wire(json.loads(json.dumps(csr_to_wire(rect))))
    _assert_csr_equal(rect, B)
    assert B.shape == (3, 7)


def test_csr_fp32_payload_rounds_values_and_fingerprints_decoded_form():
    A = laplace_3d(4)
    A.data[:] *= 1 + 1e-12          # not exactly representable in fp32
    payload = csr_to_wire(A, dtype="float32")
    B, fp = csr_from_wire(payload)
    np.testing.assert_array_equal(B.data,
                                  A.data.astype(np.float32).astype(np.float64))
    # fingerprint is of what the receiver decodes, not the sender's fp64 form
    assert fp == payload["fingerprint"] == matrix_fingerprint(B)
    assert fp != matrix_fingerprint(A)
    # and the fp32 payload is about half the bytes of the fp64 one
    assert (len(payload["data"]["data"])
            < 0.6 * len(csr_to_wire(A)["data"]["data"]))


def test_csr_corruption_detected():
    payload = csr_to_wire(laplace_3d(4))
    tampered = json.loads(json.dumps(payload))
    raw = np.frombuffer(base64.b64decode(tampered["data"]["data"]),
                        dtype="<f8").copy()
    raw[0] += 1.0
    tampered["data"]["data"] = base64.b64encode(raw.tobytes()).decode()
    with pytest.raises(WireError, match="fingerprint mismatch"):
        csr_from_wire(tampered)
    broken = json.loads(json.dumps(payload))
    broken["indices"]["data"] = "!!!not-base64!!!"
    with pytest.raises(WireError):
        csr_from_wire(broken)


# ----------------------------------------------------------------- configs
def test_config_wire_identity_for_every_registered_backend():
    """dict -> wire -> dict identity for each backend the registry knows
    (the torch backend's device stated, as a config off the card must)."""
    assert {"host", "torch"} <= set(available_backends())
    for name in available_backends():
        cfg = AMGConfig(backend=name, n_pods=2, lanes=4, theta=0.2,
                        machine="blue_waters", dtype="float64", device="cpu",
                        opts=SolveOptions(cycle="W", smoother="hybrid_gs_sym"))
        payload = json.loads(json.dumps(cfg.to_wire()))
        back = AMGConfig.from_wire(payload)
        assert back == cfg
        assert back.to_dict() == cfg.to_dict()
        assert back.to_wire() == cfg.to_wire()


def test_config_wire_rejects_invalid_values():
    bad = AMGConfig().to_wire()
    bad["dtype"] = "float16"
    with pytest.raises(WireError, match="rejected"):
        AMGConfig.from_wire(bad)


# ---------------------------------------------------------- solve requests
def test_solve_request_round_trip():
    b = np.linspace(0, 1, 12).reshape(6, 2)
    x0 = np.zeros((6, 2))
    payload = json.loads(json.dumps(solve_request_to_wire(
        "abc123", b, method="pcg", tol=1e-5, maxiter=17, x0=x0,
        priority="interactive", rid=9)))
    kw = solve_request_from_wire(payload)
    assert kw["matrix_id"] == "abc123"
    o = kw["options"]
    assert isinstance(o, RequestOptions)
    assert o.method == "pcg" and o.tol == 1e-5 and o.maxiter == 17
    assert kw["rid"] == 9 and kw["priority"] == "interactive"
    np.testing.assert_array_equal(kw["b"], b)
    np.testing.assert_array_equal(o.x0, x0)
    # optional fields stay absent (RequestOptions.resolve applies the
    # service config's defaults later)
    lean = solve_request_from_wire(solve_request_to_wire("m", b[:, 0]))
    assert set(lean) == {"matrix_id", "b", "options"}
    assert lean["options"].tol is None and lean["options"].maxiter is None


def test_solve_request_options_object_round_trips():
    b = np.ones(5)
    opts = RequestOptions(method="pcg", tol=1e-4, maxiter=11)
    payload = json.loads(json.dumps(solve_request_to_wire(
        "m", b, options=opts)))
    kw = solve_request_from_wire(payload)
    back = kw["options"]
    assert (back.method, back.tol, back.maxiter) == ("pcg", 1e-4, 11)
    with pytest.raises(ValueError, match="not both"):
        solve_request_to_wire("m", b, options=opts, tol=1e-3)


def test_v1_solve_request_still_decodes():
    """A v1 frame (flat knob fields, schema tag 1) must decode on the v2
    stack; a v1 frame smuggling the v2-only nested options dict must not
    (strict mode)."""
    assert set(SUPPORTED_SCHEMAS) == {1, 2} and WIRE_SCHEMA == 2
    b = np.linspace(0, 1, 6)
    payload = json.loads(json.dumps(solve_request_to_wire(
        "m", b, method="pcg", tol=1e-5, maxiter=9)))
    v1 = {**payload, "schema": 1}
    kw = solve_request_from_wire(v1)
    o = kw["options"]
    assert (o.method, o.tol, o.maxiter) == ("pcg", 1e-5, 9)
    np.testing.assert_array_equal(kw["b"], b)
    # additive v2 key on a v1-tagged frame: rejected strict, tolerated lax
    v1_plus = {**v1, "options": {"method": "solve"}}
    with pytest.raises(WireError, match="v2-only"):
        solve_request_from_wire(v1_plus)
    lax = solve_request_from_wire(v1_plus, strict=False)
    assert lax["options"].method == "solve"


# --------------------------------------------------------- update requests
def test_update_request_round_trip_all_forms():
    A = laplace_3d(4)
    # full-CSR form
    kw = update_request_from_wire(json.loads(json.dumps(
        update_request_to_wire("mid", A, rid=3))))
    assert kw["matrix_id"] == "mid" and kw["rid"] == 3
    _assert_csr_equal(kw["A"], A)
    # values-on-pattern form
    vals = A.data * 1.5
    kw = update_request_from_wire(json.loads(json.dumps(
        update_request_to_wire("mid", data=vals))))
    np.testing.assert_array_equal(kw["data"], vals)
    assert "A" not in kw and "delta" not in kw
    # additive-delta form
    kw = update_request_from_wire(json.loads(json.dumps(
        update_request_to_wire("mid", delta=0.1 * vals))))
    np.testing.assert_allclose(kw["delta"], 0.1 * vals)
    # exactly one form, encoder side
    with pytest.raises(ValueError, match="exactly one"):
        update_request_to_wire("mid", A, data=vals)
    with pytest.raises(ValueError, match="exactly one"):
        update_request_to_wire("mid")


def test_update_request_is_v2_only_and_strict():
    A = laplace_3d(4)
    payload = json.loads(json.dumps(update_request_to_wire("mid", A)))
    assert payload["schema"] == 2
    with pytest.raises(WireError, match="schema"):
        update_request_from_wire({**payload, "schema": 1})
    with pytest.raises(WireError, match="unknown key"):
        update_request_from_wire({**payload, "hint": "fast"})
    both = dict(payload)
    both["data"] = array_to_wire(A.data)
    with pytest.raises(WireError, match="exactly one"):
        update_request_from_wire(both)


# ----------------------------------------------- framed envelope (serve.wire)
def test_envelope_accepts_every_supported_schema():
    from repro_torch.serve.wire import check_request_envelope, hello_frame
    for schema in SUPPORTED_SCHEMAS:
        assert check_request_envelope(
            {"schema": schema, "kind": "solve", "seq": 0}) == "solve"
    # the update kind is v2-only at the envelope level too
    assert check_request_envelope(
        {"schema": 2, "kind": "update", "seq": 0}) == "update"
    with pytest.raises(WireError, match="needs schema >= 2"):
        check_request_envelope({"schema": 1, "kind": "update", "seq": 0})
    with pytest.raises(WireError, match="schema version mismatch"):
        check_request_envelope({"schema": WIRE_SCHEMA + 1, "kind": "solve"})
    hello = hello_frame(["alpha"])
    assert hello["kind"] == "hello" and hello["seq"] is None
    assert hello["supported_schemas"] == list(SUPPORTED_SCHEMAS)
    assert hello["tenants"] == ["alpha"]


# ------------------------------------------------------- eviction policies
class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_lru_policy_matches_old_cache_behavior():
    """16-entry default, oldest-unused first, gets refresh recency — the
    module-global cache contract the store replaced."""
    store = SessionStore(LRUPolicy(16))
    for i in range(16):
        store.put(i, f"v{i}")
    assert len(store) == 16
    assert store.get(0) == "v0"          # refresh 0's recency
    store.put(16, "v16")                 # evicts 1, the LRU entry
    assert len(store) == 16
    assert 1 not in store and 0 in store and 16 in store
    st = store.stats()
    assert st["evictions"] == 1 and st["policy"] == "lru"
    assert st["hits"] == 1 and st["misses"] == 0


def test_ttl_policy_expires_idle_entries():
    clock = FakeClock()
    store = SessionStore(TTLPolicy(ttl=10.0), clock=clock)
    store.put("a", 1)
    clock.t = 5.0
    assert store.get("a") == 1           # touched at t=5 -> fresh until 15
    clock.t = 14.0
    assert store.get("a") == 1
    clock.t = 25.0
    assert store.get("a") is None        # idle 11s > ttl
    st = store.stats()
    assert st["expirations"] == 1 and st["entries"] == 0
    assert st["misses"] == 1 and st["hits"] == 2


def test_bytes_budget_prefers_cheap_to_rebuild():
    """Same-size entries: the low-setup-cost (cheap to rebuild) session is
    evicted first; hit counts raise retention."""
    store = SessionStore(BytesBudgetPolicy(max_bytes=300))
    store.put("expensive", "E", nbytes=100, setup_cost=10.0)
    store.put("cheap", "C", nbytes=100, setup_cost=0.1)
    store.put("mid", "M", nbytes=100, setup_cost=1.0)
    assert len(store) == 3               # exactly at budget
    store.put("new", "N", nbytes=100, setup_cost=1.0)   # 400 > 300
    assert "cheap" not in store          # lowest setup_cost went first
    assert "expensive" in store and "mid" in store
    st = store.stats()
    assert st["evictions"] == 1
    assert st["setup_cost_evicted"] == pytest.approx(0.1)
    # hits buy retention: heavily-hit cheap entry outlives an unhit one
    store2 = SessionStore(BytesBudgetPolicy(max_bytes=200))
    store2.put("hot_cheap", 1, nbytes=100, setup_cost=0.1)
    store2.put("cold_mid", 2, nbytes=100, setup_cost=0.5)
    for _ in range(20):                  # 0.1 * 21 > 0.5 * 1
        store2.get("hot_cheap")
    store2.put("new", 3, nbytes=100, setup_cost=1.0)
    assert "hot_cheap" in store2 and "cold_mid" not in store2


def test_bytes_budget_eviction_order_is_retention_ranked():
    """Multiple evictions in one put drop entries in ascending retention
    value order until the budget holds."""
    store = SessionStore(BytesBudgetPolicy(max_bytes=300))
    store.put("a", 1, nbytes=100, setup_cost=5.0)
    store.put("b", 2, nbytes=100, setup_cost=0.2)
    store.put("c", 3, nbytes=100, setup_cost=0.4)
    store.put("big", 4, nbytes=200, setup_cost=100.0)   # 500 resident
    # b (0.002/B) then c (0.004/B) go; "big" (0.5/B) and "a" (0.05/B) stay
    assert "b" not in store and "c" not in store
    assert "a" in store and "big" in store
    assert store.stats()["bytes"] == 300
    # entry accounting surfaces per-entry cost/hits for reports
    table = {row["key"]: row for row in store.entry_table()}
    assert table["big"]["setup_cost"] == 100.0
    assert table["a"]["nbytes"] == 100


# ------------------------------------------------ against the reference
def _frames(api, A):
    """The same frames built through one side's codec (``api``: the
    reference's ``repro.amg.api`` or the port's)."""
    b = np.linspace(-1.0, 1.0, A.nrows)
    return [
        {"schema": 2, "kind": "register", "tenant": "alpha", "seq": 0,
         "payload": api.csr_to_wire(A)},
        {"schema": 2, "kind": "register", "tenant": "alpha", "seq": 1,
         "payload": api.csr_to_wire(A, dtype="float32")},
        {"schema": 2, "kind": "solve", "tenant": "alpha", "seq": 2,
         "payload": api.solve_request_to_wire(
             "m", np.stack([b, 2 * b], 1), method="pcg", tol=1e-7,
             maxiter=9, priority="batch", rid=4)},
        {"schema": 1, "kind": "solve", "tenant": "beta", "seq": 3,
         "payload": api.solve_request_to_wire("m", b, x0=b)},
        {"schema": 2, "kind": "update", "tenant": "alpha", "seq": 4,
         "payload": api.update_request_to_wire("m", delta=0.1 * A.data,
                                               rid=5)},
        {"schema": 2, "kind": "solution", "seq": 2,
         "x": api.array_to_wire(b), "diagnostics": {"converged": True}},
    ]


def test_frames_are_byte_equal_to_the_reference():
    import repro.amg.api as ref_api
    from repro.amg.problems import laplace_3d as ref_laplace_3d
    from repro.serve import wire as ref_wire
    from repro_torch.amg import api
    from repro_torch.serve import wire
    A, A_ref = laplace_3d(5), ref_laplace_3d(5)
    ours, theirs = _frames(api, A), _frames(ref_api, A_ref)
    for mine, ref in zip(ours, theirs):
        assert wire.encode_frame(mine) == ref_wire.encode_frame(ref), mine["kind"]
    for mine, ref in ((wire.hello_frame(["b", "a"]),
                       ref_wire.hello_frame(["b", "a"])),
                      (wire.error_frame(7, KeyError("m"), 404),
                       ref_wire.error_frame(7, KeyError("m"), 404)),
                      (wire.response_frame("pong", 3, tenants=["a"]),
                       ref_wire.response_frame("pong", 3, tenants=["a"]))):
        assert wire.encode_frame(mine) == ref_wire.encode_frame(ref)
    assert wire.MAX_FRAME_BYTES == ref_wire.MAX_FRAME_BYTES == 1 << 26
    assert wire.REQUEST_KINDS == ref_wire.REQUEST_KINDS
    assert wire.RESPONSE_KINDS == ref_wire.RESPONSE_KINDS


def test_oversized_frames_drain_and_stay_aligned(monkeypatch):
    from repro_torch.serve import wire
    good = wire.encode_frame({"ok": 1})
    big = json.dumps({"pad": "x" * 4096}).encode()

    async def go():
        reader = asyncio.StreamReader()
        reader.feed_data(struct.pack(">I", len(big)) + big + good + good)
        reader.feed_eof()
        with pytest.raises(wire.FrameTooLarge, match="exceeds"):
            await wire.read_frame(reader, max_frame=1024)
        assert await wire.read_frame(reader, max_frame=1024) == {"ok": 1}
        assert await wire.read_frame(reader, max_frame=1024) == {"ok": 1}
        assert await wire.read_frame(reader) is None
    asyncio.run(go())
    # the sender refuses a frame over the limit rather than cut it
    monkeypatch.setattr(wire, "MAX_FRAME_BYTES", 64)
    with pytest.raises(wire.FrameTooLarge):
        wire.encode_frame({"pad": "x" * 64})
