"""AMGWire on the torch backend, mirroring the reference suite's
``tests/test_server.py``: framing, multi-tenant admission, backpressure and
the end-to-end socket error paths.

Everything runs real sockets on the loopback against a
:class:`~repro_torch.serve.server.ServerThread` whose tenants solve on
``backend="torch"`` (float64, 2×4 ranks, ``device="cpu"``), driven by the
blocking :class:`~repro_torch.serve.client.AMGWireClient`.  Every failure
mode — malformed JSON, schema mismatch, unknown tenant/matrix, over-quota
submission, server shutdown with requests queued — surfaces as a structured
frame on a surviving connection.

Every solution is held against the reference's ``AMGWireServer`` (host
backend) answering the same request bytes: ``‖A (x − x_ref)‖ ≤ 1e-7 ‖b‖``
(b is r0: every solve starts from zero), the port's bar.  Waits for
admission poll the server's stats for the queued request, with a deadline;
none sleeps.
"""
import asyncio
import json
import struct
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.amg.api import AMGConfig as RefAMGConfig  # noqa: E402
from repro.serve import AMGWireClient as RefClient  # noqa: E402
from repro.serve import ServerThread as RefServerThread  # noqa: E402
from repro.serve import TenantSpec as RefTenantSpec  # noqa: E402
from repro_torch.amg.api import (AMGConfig, array_from_wire,  # noqa: E402
                                 clear_sessions, csr_to_wire)
from repro_torch.amg.api.service import AMGService, ServiceClosed  # noqa: E402
from repro_torch.serve import (AMGWireClient, BadFrame, FrameTooLarge,  # noqa: E402
                               Rejected, RemoteError, ServerThread,
                               TenantSpec, encode_frame, read_frame,
                               ticket_future)
from repro_torch.serve.workload import (build_problems, make_request,  # noqa: E402
                                        rel_residual)

TOL = 1e-7            # ‖A (x − x_ref)‖ / ‖r0‖


@pytest.fixture(autouse=True)
def _fresh_sessions():
    clear_sessions()
    yield
    clear_sessions()


@pytest.fixture(scope="module")
def problems():
    return build_problems(6, count=1)


def _cfg(**kw):
    return AMGConfig(**{**dict(backend="torch", n_pods=2, lanes=4,
                               dtype="float64", device="cpu"), **kw})


def _spec(**kw):
    kw.setdefault("config", _cfg())
    return TenantSpec(**kw)


@pytest.fixture(scope="module")
def reference(problems):
    """The reference's server (host backend) with the same matrix
    registered; ``reference(payload)`` answers one solve request."""
    mid, A = next(iter(problems.items()))
    with RefServerThread({"t0": RefTenantSpec(config=RefAMGConfig(),
                                              max_inflight=64)}) as srv:
        with RefClient.connect(srv.host, srv.port) as c:
            assert c.register("t0", csr_to_wire(A))["matrix"] == mid
            lock = threading.Lock()

            def solve(payload):
                with lock:
                    return c.solve("t0", payload, timeout=120)
            yield solve


def _same_answer(reference, A, b, payload, x, diag):
    x_ref, diag_ref = reference(payload)
    assert diag["iterations"] == diag_ref["iterations"]
    err = np.linalg.norm(A.matvec(x - x_ref)) / np.linalg.norm(b)
    assert err <= TOL, err


def _wait_admitted(c, tenant, n, timeout=60.0):
    """Poll the server's stats until ``tenant`` has admitted ``n``
    requests (the frames of one connection are handled in order, so the
    answer reflects every request sent before it)."""
    deadline = time.monotonic() + timeout
    while c.stats(tenant)["tenants"][tenant]["admitted"] < n:
        if time.monotonic() > deadline:
            raise TimeoutError(f"{tenant}: {n} admissions not seen in "
                               f"{timeout} s")


# ---------------------------------------------------------------- framing
def _feed(*chunks: bytes) -> asyncio.StreamReader:
    reader = asyncio.StreamReader()
    for chunk in chunks:
        reader.feed_data(chunk)
    reader.feed_eof()
    return reader


def test_frame_round_trip():
    async def go():
        frames = [{"schema": 1, "kind": "ping", "seq": 0},
                  {"a": [1, 2, 3], "b": None}]
        reader = _feed(b"".join(encode_frame(f) for f in frames))
        assert await read_frame(reader) == frames[0]
        assert await read_frame(reader) == frames[1]
        assert await read_frame(reader) is None          # clean EOF
    asyncio.run(go())


def test_frame_errors_keep_stream_aligned():
    async def go():
        good = encode_frame({"ok": 1})
        big = json.dumps({"pad": "x" * 256}).encode()
        reader = _feed(struct.pack(">I", len(big)) + big, good)
        with pytest.raises(FrameTooLarge):
            await read_frame(reader, max_frame=64)
        assert await read_frame(reader, max_frame=64) == {"ok": 1}
        bad = b"not json at all"
        reader = _feed(struct.pack(">I", len(bad)) + bad, good)
        with pytest.raises(BadFrame):
            await read_frame(reader)
        assert await read_frame(reader) == {"ok": 1}
        arr = json.dumps([1, 2]).encode()
        reader = _feed(struct.pack(">I", len(arr)) + arr)
        with pytest.raises(BadFrame):
            await read_frame(reader)
        reader = _feed(struct.pack(">I", 100) + b"only-ten-b")
        assert await read_frame(reader) is None          # mid-frame EOF
    asyncio.run(go())


# ----------------------------------------------------- ticket adapter
def test_ticket_future_resolves_on_loop(problems):
    mid, A = next(iter(problems.items()))
    b = A.matvec(np.ones(A.nrows))

    async def go():
        svc = AMGService(_cfg())
        svc.register(mid, A)
        with svc:
            fut = ticket_future(svc.submit(mid, b, method="pcg"),
                                asyncio.get_running_loop())
            x, diag = await asyncio.wait_for(fut, 60)
        assert diag["converged"]
        assert rel_residual(A, x, b) < 1e-6
        svc2 = AMGService(_cfg())
        svc2.register(mid, A)
        t = svc2.submit(mid, b)
        fut2 = ticket_future(t, asyncio.get_running_loop())
        svc2.close(flush=False)              # fails the queued ticket
        with pytest.raises(ServiceClosed):
            await asyncio.wait_for(fut2, 60)
    asyncio.run(go())


# ------------------------------------------------------- happy path
def test_register_solve_round_trip(problems, reference):
    mid, A = next(iter(problems.items()))
    rng = np.random.default_rng(0)
    with ServerThread({"t0": _spec()}) as srv:
        with AMGWireClient.connect(srv.host, srv.port) as c:
            assert c.ping()["tenants"] == ["t0"]
            reg = c.register("t0", csr_to_wire(A))
            assert reg["matrix"] == mid
            for method in ("pcg", "solve"):
                b, payload = make_request(rng, problems, mid, method=method)
                x, diag = c.solve("t0", payload)
                assert diag["converged"] and diag["method"] == method
                assert rel_residual(A, x, b) < 1e-6
                _same_answer(reference, A, b, payload, x, diag)
            st = c.stats()["tenants"]["t0"]
            assert st["registered"] == 1
            assert st["admitted"] == st["completed"] == 2
            assert st["rejected"] == st["errors"] == 0
            assert st["store"]["bytes"] > 0


def test_pipelined_out_of_order_completion(problems, reference):
    """Pipelined solves down one connection, one of them ``[n, 2]``,
    harvested in reverse send order — seq correlation matches each
    response to its request."""
    mid, A = next(iter(problems.items()))
    rng = np.random.default_rng(1)
    with ServerThread({"t0": _spec(max_inflight=64,
                                   coalesce_window=0.2)}) as srv:
        with AMGWireClient.connect(srv.host, srv.port) as c:
            c.register("t0", csr_to_wire(A))
            sent = []
            for _ in range(12):
                b, payload = make_request(rng, problems, mid)
                sent.append((b, payload, c.send("solve", tenant="t0",
                                                payload=payload)))
            for b, payload, seq in reversed(sent):
                frame = c.recv(seq, timeout=120)
                assert frame["kind"] == "solution"
                x = array_from_wire(frame["x"])
                assert rel_residual(A, x, b) < 1e-6
                err = np.linalg.norm(A.matvec(x - reference(payload)[0]))
                assert err <= TOL * np.linalg.norm(b)
            st = c.stats()["tenants"]["t0"]["service"]
            assert st["batched_rhs"] >= 2          # coalesced into *_m


# -------------------------------------------------- wire error paths
def test_malformed_json_yields_error_frame_and_connection_survives(problems):
    mid, A = next(iter(problems.items()))
    with ServerThread({"t0": _spec()}) as srv:
        with AMGWireClient.connect(srv.host, srv.port) as c:
            c.send_raw(b"{this is not json")
            frame = c.recv_unmatched()
            assert frame["kind"] == "error"
            assert frame["code"] == 400
            assert frame["error"] == "BadFrame"
            assert c.ping()["kind"] == "pong"
            assert c.register("t0", csr_to_wire(A))["matrix"] == mid


def test_schema_version_mismatch_yields_error_frame():
    with ServerThread({"t0": _spec()}) as srv:
        with AMGWireClient.connect(srv.host, srv.port) as c:
            c.send_raw(json.dumps({"schema": 99, "kind": "ping",
                                   "seq": 3}).encode())
            frame = c.recv_unmatched()
            assert frame["kind"] == "error" and frame["code"] == 400
            assert "schema version mismatch" in frame["message"]
            assert frame["seq"] == 3
            c.send_raw(json.dumps({"schema": 1, "kind": "nope",
                                   "seq": 4}).encode())
            frame = c.recv_unmatched()
            assert frame["kind"] == "error" and frame["code"] == 400
            assert "unknown frame kind" in frame["message"]
            assert c.ping()["kind"] == "pong"


def test_unknown_tenant_and_matrix_yield_404(problems):
    mid, A = next(iter(problems.items()))
    rng = np.random.default_rng(2)
    with ServerThread({"t0": _spec()}) as srv:
        with AMGWireClient.connect(srv.host, srv.port) as c:
            _, payload = make_request(rng, problems, mid)
            with pytest.raises(RemoteError) as ei:
                c.solve("ghost", payload)
            assert ei.value.code == 404
            with pytest.raises(RemoteError) as ei:
                c.solve("t0", payload)
            assert ei.value.code == 404
            assert ei.value.error == "KeyError"
            st = c.stats()["tenants"]["t0"]
            assert st["errors"] == 1
            assert st["service"]["errors"] == 0   # rejected pre-admission
            assert c.ping()["kind"] == "pong"


def test_strict_codec_rejection_crosses_the_wire(problems):
    mid, A = next(iter(problems.items()))
    rng = np.random.default_rng(3)
    with ServerThread({"t0": _spec()}) as srv:
        with AMGWireClient.connect(srv.host, srv.port) as c:
            c.register("t0", csr_to_wire(A))
            _, payload = make_request(rng, problems, mid)
            payload["surprise"] = True
            with pytest.raises(RemoteError) as ei:
                c.solve("t0", payload)
            assert ei.value.code == 400
            assert ei.value.error == "WireError"
            assert "unknown key" in str(ei.value)
            bad = csr_to_wire(A)
            bad["fingerprint"] = "0" * 40
            with pytest.raises(RemoteError) as ei:
                c.register("t0", bad)
            assert ei.value.code == 400 and ei.value.error == "WireError"
            assert c.stats()["tenants"]["t0"]["errors"] == 2


# ------------------------------------------------- quotas + shedding
def test_matrix_byte_quota_rejects_with_429(problems):
    mid, A = next(iter(problems.items()))
    with ServerThread({"t0": _spec(max_matrix_bytes=10)}) as srv:
        with AMGWireClient.connect(srv.host, srv.port) as c:
            with pytest.raises(Rejected) as ei:
                c.register("t0", csr_to_wire(A))
            assert ei.value.frame["code"] == 429
            assert ei.value.frame["reason"] == "matrix byte quota"
            st = c.stats()["tenants"]["t0"]
            assert st["rejected"] == 1 and st["registered"] == 0
            assert c.ping()["kind"] == "pong"


def test_overload_sheds_batch_before_interactive(problems):
    """With max_inflight=2 the batch class admits at most 1 in-flight
    request while interactive may fill both slots; a huge coalescing
    window keeps admitted work queued so the counters are deterministic.
    """
    mid, A = next(iter(problems.items()))
    rng = np.random.default_rng(4)
    spec = _spec(max_inflight=2, coalesce_window=120.0)
    with ServerThread({"t0": spec}) as srv:
        with AMGWireClient.connect(srv.host, srv.port) as c:
            c.register("t0", csr_to_wire(A))

            def send(priority):
                _, payload = make_request(rng, problems, mid,
                                          priority=priority)
                return c.send("solve", tenant="t0", payload=payload)

            send("batch")                         # the 1 batch slot
            _wait_admitted(c, "t0", 1)
            frame = c.recv(send("batch"), timeout=60)   # over the limit
            assert frame["kind"] == "rejected" and frame["code"] == 429
            assert frame["priority"] == "batch"
            assert frame["limit"] == 1
            send("interactive")                   # headroom: limit 2
            _wait_admitted(c, "t0", 2)
            frame = c.recv(send("interactive"), timeout=60)  # now full
            assert frame["kind"] == "rejected"
            assert frame["priority"] == "interactive"
            assert frame["limit"] == 2
            st = c.stats()["tenants"]["t0"]
            assert st["admitted"] == 2 and st["rejected"] == 2
            assert st["rejected_by_class"] == {"batch": 1,
                                               "interactive": 1}


def test_shutdown_fails_queued_solves_with_structured_503(problems):
    mid, A = next(iter(problems.items()))
    rng = np.random.default_rng(5)
    srv = ServerThread({"t0": _spec(max_inflight=4, coalesce_window=120.0)})
    srv.__enter__()
    try:
        c = AMGWireClient.connect(srv.host, srv.port)
        c.register("t0", csr_to_wire(A))
        _, payload = make_request(rng, problems, mid)
        seq = c.send("solve", tenant="t0", payload=payload)
        _wait_admitted(c, "t0", 1)                # queued in the service
    finally:
        srv.__exit__(None, None, None)            # close with it queued
    frame = c.recv(seq, timeout=60)
    assert frame["kind"] == "error"
    assert frame["code"] == 503
    assert frame["error"] == "ServiceClosed"
    c.close()


# -------------------------------------------------- concurrency scale
def test_32_concurrent_connections_two_tenants(problems, reference):
    """32 live connections across two tenants, all solving at once: every
    response is structured, nothing drops, both tenants' accounting adds
    up, and every answer is the reference's."""
    mid, A = next(iter(problems.items()))
    tenants = {"alpha": _spec(max_inflight=64),
               "beta": _spec(max_inflight=64)}
    names = sorted(tenants)
    results, errors = [], []
    with ServerThread(tenants) as srv:
        with AMGWireClient.connect(srv.host, srv.port) as admin:
            for t in names:
                admin.register(t, csr_to_wire(A))

            def worker(i):
                rng = np.random.default_rng(100 + i)
                try:
                    with AMGWireClient.connect(srv.host, srv.port) as c:
                        b, payload = make_request(rng, problems, mid,
                                                  priority="interactive")
                        x, diag = c.solve(names[i % 2], payload,
                                          timeout=120)
                        results.append((b, payload, x, diag))
                except Exception as e:            # pragma: no cover
                    errors.append(e)

            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(32)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=180)
            assert not any(t.is_alive() for t in threads)
            assert not errors
            assert len(results) == 32
            for b, payload, x, diag in results:
                assert rel_residual(A, x, b) < 1e-6
                _same_answer(reference, A, b, payload, x, diag)
            st = admin.stats()
            assert st["dropped_connections"] == 0
            for name in names:
                ts = st["tenants"][name]
                assert ts["completed"] == 16
                assert ts["errors"] == 0


def test_torch_tenant_refuses_to_start_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TenantSpec(config=AMGConfig(backend="torch"))


# ------------------------------------------------------------ the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_wire_solve_on_the_card_equals_in_process_service(problems, cuda):
    """One solve over the wire on the card and the same b through an
    in-process AMGService on the same session: the same captured graph
    runs both, so the answers are equal."""
    mid, A = next(iter(problems.items()))
    rng = np.random.default_rng(6)
    cfg = _cfg(device="cuda")
    with ServerThread({"t0": _spec(config=cfg)}) as srv:
        with AMGWireClient.connect(srv.host, srv.port) as c:
            c.register("t0", csr_to_wire(A))
            b, payload = make_request(rng, problems, mid)
            x, diag = c.solve("t0", payload)
            dh = srv.server.tenants["t0"].service.bound_for(mid) \
                .dist_hierarchy
            assert dh.programs.get("pcg_step", cfg.opts).graph is not None
    svc = AMGService(cfg)
    svc.register(mid, A)
    t = svc.submit(mid, b, method="pcg")
    svc.drain()
    x_in, diag_in = t.result(timeout=0), t.diagnostics
    assert diag["iterations"] == diag_in["iterations"]
    assert np.abs(x - x_in).max() <= 1e-12 * np.abs(x_in).max()
    assert rel_residual(A, x, b) < 1e-6
