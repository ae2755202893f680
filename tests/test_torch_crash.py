"""Crash-only serve in the port: the twins of the single-process cases of
tests/test_crash.py (the submission journal's replay edge cases, the
journal-plus-checkpoint ordering of `recover()`, the write failure that
un-accepts a submit, and the lease table), each held to the JAX
package; and the cross-package resume in both directions: a group
checkpoint and a journal written by the JAX `Scheduler` are resumed by
the port's, and the port's by the JAX one's, bit-identically (the
checkpoint file layout and the journal rows are the same in both)."""

import os
import time

import pytest
import serve_parity as sp
import torch
import torch_parity as tp

from wittgenstein_tpu_torch import convert


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spec(**kw):
    base = dict(protocol="PingPong", params={"node_count": 64},
                seeds=(0, 1), sim_ms=120, chunk_ms=40, obs=("metrics",))
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def reference():
    """The uninterrupted run of the canonical spec in the JAX package
    (numpy leaves) — what every crash path below must land on."""
    js = sp.jax_serve()
    sch = js.Scheduler()
    rid = sch.submit(sp.specs(_spec())[0])
    sch.run_pending()
    return tp.jax_state(*sch.request(rid).final_state)


def _mod(k):
    return (sp.jax_serve(), sp.port_serve())[k]


def _dev(k):
    return {} if k == 0 else {"device": "cpu"}


def _state(k, req):
    return tp.jax_state(*req.final_state) if k == 0 else \
        convert.to_numpy(*req.final_state)


def _killer(n):
    """A launcher that dies from its n-th call on (one call a chunk in
    both packages for a metrics-only spec)."""
    calls = {"n": 0}

    def launcher(fn, *args):
        calls["n"] += 1
        if calls["n"] >= n:
            raise RuntimeError("KILLED")
        return fn(*args)
    return launcher


def test_journal_replays_queued_but_unlaunched(reference, tmp_path):
    """Accepted submits that never launched replay in a fresh scheduler
    with their rids, labels and ledger_extra, run bit-identically, and
    tombstone the journal — in both packages alike."""
    out = []
    for k in (0, 1):
        mod = _mod(k)
        jd = str(tmp_path / f"journal{k}")
        dying = mod.Scheduler(journal_dir=jd, **_dev(k))
        a = dying.submit(sp.specs(_spec())[k], label="crash:a",
                         ledger_extra={"campaign": "x"})
        b = dying.submit(sp.specs(_spec(seeds=(7,)))[k])
        assert mod.SubmissionJournal(jd).lag() == 2
        fresh = mod.Scheduler(journal_dir=jd, ledger_path=str(
            tmp_path / f"led{k}.jsonl"), **_dev(k))
        got = fresh.recover()
        assert got == {"checkpoints": [], "journal": [a, b]}
        assert fresh.request(a).label == "crash:a"
        assert fresh.request(a).ledger_extra == {"campaign": "x"}
        fresh.run_pending()
        assert mod.SubmissionJournal(jd).lag() == 0
        assert fresh.resilience["replayed"] == 2
        tp.assert_states_equal(reference, _state(k, fresh.request(a)),
                               f"package {k}")
        out.append((fresh, [a, b]))
        if k:
            # the journal rows are the JAX package's but for their
            # timestamps (``ts_unix``)
            from wittgenstein_tpu_torch.utils import jsonl
            rows = [[{k_: v for k_, v in row.items() if k_ != "ts_unix"}
                     for _, row in jsonl.iter_lines(os.path.join(
                         d, "submissions.jsonl"))]
                    for d in (str(tmp_path / "journal0"), jd)]
            assert rows[0] == rows[1]
    (jsch, jr), (psch, pr) = out
    sp.assert_schedulers_equal(jsch, psch, jr, pr, "replayed")
    assert sp.manifest_rows(tmp_path / "led0.jsonl") == \
        sp.manifest_rows(tmp_path / "led1.jsonl")


def test_double_replay_refuses_duplicate_rids(tmp_path):
    ps = sp.port_serve()
    jd = str(tmp_path / "journal")
    ps.Scheduler(journal_dir=jd, device="cpu").submit(sp.specs(_spec())[1])
    fresh = ps.Scheduler(journal_dir=jd, device="cpu")
    assert len(fresh.resume_journal()) == 1
    assert fresh.resume_journal() == []
    assert len(fresh.pending()) == 1


def test_tombstone_then_torn_tail_tolerated(tmp_path, capsys):
    """A torn final line after valid submit/tombstone rows: the
    tombstoned entry stays dead, the live one replays, the torn line is
    skipped loudly, and compaction keeps the live entry only."""
    ps = sp.port_serve()
    jd = str(tmp_path / "journal")
    j = ps.SubmissionJournal(jd)
    j.record_submit("r0001", sp.specs(_spec())[1])
    j.record_submit("r0002", sp.specs(_spec(seeds=(7,)))[1])
    j.record_settled("r0001", "done")
    with open(j.path, "a") as f:
        f.write('{"kind": "submit", "rid": "r00')
    fresh = ps.Scheduler(journal_dir=jd, device="cpu")
    assert fresh.resume_journal() == ["r0002"]
    assert "torn final line" in capsys.readouterr().err
    rows = open(j.path).read().strip().splitlines()
    assert len(rows) == 1 and '"r0002"' in rows[0]


def test_journal_plus_checkpoint_resumes_from_checkpoint(reference,
                                                         tmp_path):
    """A request with BOTH a journal entry and a group checkpoint
    resumes from the checkpoint (progress kept), the journal entry
    skipped by rid — equal to the JAX package's recovery."""
    out = []
    for k in (0, 1):
        mod = _mod(k)
        ck, jd = str(tmp_path / f"ck{k}"), str(tmp_path / f"j{k}")
        crashed = mod.Scheduler(launcher=_killer(2), retry_backoff_s=0.0,
                                max_retries=0, checkpoint_dir=ck,
                                journal_dir=jd, **_dev(k))
        rid = crashed.submit(sp.specs(_spec())[k])
        crashed.run_pending()
        assert crashed.request(rid).status == "error"
        assert os.listdir(ck) and mod.SubmissionJournal(jd).lag() == 1
        fresh = mod.Scheduler(checkpoint_dir=ck, journal_dir=jd, **_dev(k))
        got = fresh.recover()
        assert len(got["checkpoints"]) == 1 and got["journal"] == []
        req = fresh.request(got["checkpoints"][0])
        assert req.resumed_from_ms == 40
        fresh.run_pending()
        tp.assert_states_equal(reference, _state(k, req), f"package {k}")
        assert mod.SubmissionJournal(jd).lag() == 0
        out.append((fresh, got["checkpoints"]))
    (jsch, jr), (psch, pr) = out
    sp.assert_schedulers_equal(jsch, psch, jr, pr, "recovered")


@pytest.mark.parametrize("writer", [0, 1], ids=["jax_to_port",
                                                "port_to_jax"])
def test_cross_package_checkpoint_and_journal_resume(reference, tmp_path,
                                                     writer):
    """A group checkpoint and a journal written by one package's
    `Scheduler` (killed after its first chunk, a second request still
    queued behind it under another compile key) are recovered by the
    other package's: the checkpointed request resumes from its 40-ms
    boundary, the queued one replays from the journal, both equal the
    uninterrupted runs, and the journal ends fully tombstoned."""
    reader = 1 - writer
    ck, jd = str(tmp_path / "ck"), str(tmp_path / "journal")
    w = _mod(writer)
    crashed = w.Scheduler(launcher=_killer(2), retry_backoff_s=0.0,
                          max_retries=0, checkpoint_dir=ck, journal_dir=jd,
                          **_dev(writer))
    a = crashed.submit(sp.specs(_spec())[writer])
    b = crashed.submit(sp.specs(_spec(chunk_ms=120, seeds=(2,)))[writer])
    crashed.run_pending()
    assert os.listdir(ck)
    r = _mod(reader)
    fresh = r.Scheduler(checkpoint_dir=ck, journal_dir=jd, **_dev(reader))
    got = fresh.recover()
    assert got == {"checkpoints": [a], "journal": [b]}
    fresh.run_pending()
    ra, rb = fresh.request(a), fresh.request(b)
    assert ra.status == rb.status == "done", (ra.error, rb.error)
    assert ra.resumed_from_ms == 40
    tp.assert_states_equal(reference, _state(reader, ra), "checkpointed")
    solo = r.Scheduler(**_dev(reader))
    sid = solo.submit(sp.specs(_spec(chunk_ms=120, seeds=(2,)))[reader])
    solo.run_pending()
    tp.assert_states_equal(_state(reader, solo.request(sid)),
                           _state(reader, rb), "replayed")
    assert r.SubmissionJournal(jd).lag() == 0
    assert not os.listdir(ck)


def test_empty_or_missing_journal_is_noop(tmp_path):
    ps = sp.port_serve()
    assert ps.Scheduler(device="cpu").resume_journal() == []
    sched = ps.Scheduler(journal_dir=str(tmp_path / "fresh"), device="cpu")
    assert sched.resume_journal() == []
    assert sched.health_stats()["journal_lag"] == 0


def test_journal_write_failure_unaccepts_the_submit(tmp_path):
    ps = sp.port_serve()
    sched = ps.Scheduler(journal_dir=str(tmp_path / "journal"),
                         device="cpu")
    os.makedirs(sched.journal.path)
    with pytest.raises(RuntimeError, match="NOT accepted"):
        sched.submit(sp.specs(_spec())[1])
    assert sched.pending() == [] and sched._requests == {}


# -------------------------------------------------------- fleet leases


def test_lease_double_claim_refuses_without_append(tmp_path):
    from wittgenstein_tpu_torch.serve.journal import LeaseTable
    lt = LeaseTable(str(tmp_path), ttl_s=30.0)
    assert lt.claim("r1", "wa")
    lines = open(lt.path).read().splitlines()
    assert not lt.claim("r1", "wb")
    assert open(lt.path).read().splitlines() == lines
    assert lt.holder("r1") == "wa"
    assert lt.claim("r1", "wa")
    assert len(open(lt.path).read().splitlines()) == len(lines) + 1


def test_lease_race_lexicographic_winner_and_no_resurrection(tmp_path):
    from wittgenstein_tpu_torch.serve.journal import LEASE_SCHEMA, LeaseTable
    from wittgenstein_tpu_torch.utils import jsonl
    lt = LeaseTable(str(tmp_path), ttl_s=30.0)
    assert lt.claim("r1", "wb")
    jsonl.append_line(lt.path, {
        "schema": LEASE_SCHEMA, "kind": "claim", "rid": "r1",
        "worker": "wa", "deadline_unix": time.time() + 30.0,
        "ts_unix": time.time()}, fsync=True)
    assert lt.holder("r1") == "wa"
    assert not lt.claim("r1", "wb")
    lt.release("r1", "wa")
    assert lt.holder("r1") is None or lt.holder("r1") == "wb"


def test_lease_torn_tail_skipped_loudly(tmp_path, capsys):
    from wittgenstein_tpu_torch.serve.journal import LeaseTable
    lt = LeaseTable(str(tmp_path), ttl_s=30.0)
    assert lt.claim("r1", "wa")
    with open(lt.path, "a") as f:
        f.write('{"kind": "claim", "rid": "r2", "worker": "w')
    assert lt.holder("r1") == "wa" and lt.holder("r2") is None
    err = capsys.readouterr().err
    assert "leases" in err and "torn final line" in err


def test_expired_lease_reclaim_replays_original_rid(reference, tmp_path):
    """A claimed journal entry whose worker died is reclaimed after the
    deadline and adopted under its ORIGINAL rid, bit-identical."""
    from wittgenstein_tpu_torch.serve.journal import LeaseTable
    ps = sp.port_serve()
    jd = str(tmp_path / "journal")
    rid = ps.Scheduler(journal_dir=jd, device="cpu").submit(
        sp.specs(_spec())[1])
    LeaseTable(jd, ttl_s=0.05).claim(rid, "wdead")
    time.sleep(0.12)
    survivor = LeaseTable(jd, ttl_s=30.0)
    assert survivor.holder(rid) is None and survivor.claim(rid, "walive")
    fresh = ps.Scheduler(journal_dir=jd, device="cpu")
    [entry] = fresh.journal.replay()
    assert fresh.adopt_journal_entry(entry) == rid
    fresh.run_pending()
    tp.assert_states_equal(reference, _state(1, fresh.request(rid)),
                           "adopted")
    assert ps.SubmissionJournal(jd).lag() == 0


def test_lease_compaction_preserves_live_claims(tmp_path):
    from wittgenstein_tpu_torch.serve.journal import LeaseTable
    lt = LeaseTable(str(tmp_path), ttl_s=30.0)
    assert lt.claim("r1", "wa") and lt.claim("r1", "wa")
    assert lt.claim("r2", "wb")
    lt.release("r2", "wb")
    lt.claim("r3", "wc", now=time.time() - 100.0)
    lt.compact()
    assert lt.live() == {"r1": "wa"}
    rows = open(lt.path).read().splitlines()
    assert len(rows) == 1 and '"wa"' in rows[0]
