# test_mesh_multiprocess.py — real 2-process smoke test.
"""Spawns two jax.distributed CPU processes (loopback coordinator, gloo
collectives, 2 forced host devices each -> a 2x2 hybrid mesh) and asserts:

- `make_hybrid_mesh` rows are process-pure (the data axis never crosses
  processes),
- `host_shard_ids` gives disjoint, covering export shards,
- `sharded_dedup_mask` over ("host", "data") makes a GLOBAL keep decision:
  a duplicate pair split across the two hosts is detected, and the corpus
  filter drops matches on every host.

Replaces the reference's fork-per-range scale-out (src/cli.py:85-129) with
actual cross-process collectives — see tests/_dcn_worker.py for the body.
"""
import json
import os
import socket
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKER = os.path.join(_REPO, "tests", "_dcn_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_hybrid_mesh_global_dedup():
    port = _free_port()
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env.pop("JAX_PLATFORMS", None)  # worker sets platform via jax.config
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")

    procs = [subprocess.Popen(
        [sys.executable, _WORKER, str(pid), "2", str(port)],
        cwd=_REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()

    results = {}
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
        line = [l for l in out.splitlines() if l.startswith("DCN_RESULT ")]
        assert line, f"no result line:\n{out[-3000:]}"
        r = json.loads(line[-1][len("DCN_RESULT "):])
        results[r["pid"]] = r

    # disjoint, covering export shards (strided like the reference's ranges)
    s0, s1 = set(results[0]["shard_ids"]), set(results[1]["shard_ids"])
    assert s0 == {0, 2, 4, 6} and s1 == {1, 3, 5, 7}

    # both processes computed the SAME global keep decision on their shards:
    # index 5 (on host 1) duplicates index 1 (on host 0) -> dropped there.
    assert results[0]["mask"] == [1, 1, 1, 1]
    assert results[1]["mask"] == [1, 0, 1, 1]

    # corpus filter is global too: index 2 (host 0) matches the corpus.
    assert results[0]["mask_corpus"] == [1, 1, 0, 1]
    assert results[1]["mask_corpus"] == [1, 0, 1, 1]
