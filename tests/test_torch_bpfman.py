"""The port's bpfman datapath (netobserv_tpu_torch/datapath/loader.py
`BpfmanFetcher`, over `datapath/syscall_bpf.py`) against the JAX package's
on REAL kernel maps.

The tests stand in for bpfman: they create genuine BPF maps, pin them on
bpffs under a directory of their own (`netobserv_torch_test_<pid>`, never
the reference suite's `netobserv_tpu_test`, so that workers running both
suites at once never tear down each other's maps), and fill them with
flow entries and per-CPU feature partials (`chip_smoke._split_maps`,
about 2 % orphan feature rows). Each comparison fills the maps
with one seeded content, drains them with the reference's fetcher, fills
them again with the same content and drains them with the port's.

- Sequential drains and drain lanes: the `EvictedFlows` byte for byte,
  orphan feature rows among them, and the maps left empty.
- The fused gate (EVICT_NATIVE_PIPELINE): drain 1 is the Python chain,
  every later drain is asserted fused (`native_path == "fused"`, the pipe
  built and not disabled: the native library's batched drain over the
  real fds), and equal to the reference's fused drain and the port's
  sequential one.
- The exporter's tables after one window, fed the port's fused drains
  bound to its pack surface, bit for bit against the JAX exporter fed the
  reference's (the RTT and DNS histograms within
  `tests/test_torch_staging`'s edge bound, as everywhere in these tests).
- The filter tries: `program_filters` into real LPM tries, and the
  self-managed fetchers' `_create_filter_tries`/`_program_filter_tries`,
  their contents against the reference's.
- The global counters' scrape and reset, the stale DNS purge and the ring
  buffer reader, as the reference suite checks them.
- The agent in bpfman mode: a `FlowsAgent` from `load_config`, and
  `python -m netobserv_tpu_torch` with EBPF_PROGRAM_MANAGER_MODE and
  EVICT_NATIVE_PIPELINE draining pinned maps through the gate.

These skip on the reference suite's condition (CAP_BPF and a writable
bpffs, `tests/test_bpfman.py:32-35`). Without maps the fetcher raises as
the reference's does; that check runs everywhere.

Tolerance: none outside the histograms' edge bound.
"""

from __future__ import annotations

import errno
import json
import os
import selectors
import shutil
import signal
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from netobserv_tpu.datapath import loader as jloader
from netobserv_tpu.datapath import syscall_bpf as jsb
from netobserv_tpu_torch import config as tcfg
from netobserv_tpu_torch.datapath import loader as tloader
from netobserv_tpu_torch.datapath import syscall_bpf as sb
from netobserv_tpu_torch.model import binfmt
from netobserv_tpu_torch.model.flow import GlobalCounter, ip_to_16

ROOT = Path(__file__).resolve().parents[1]
BPFFS = "/sys/fs/bpf"
PIN_DIR = os.path.join(BPFFS, f"netobserv_torch_test_{os.getpid()}")

BPF_MAP_TYPE_HASH = 1
BPF_MAP_TYPE_PERCPU_HASH = 5
BPF_MAP_TYPE_PERCPU_ARRAY = 6
BPF_MAP_TYPE_LPM_TRIE = 11
BPF_F_NO_PREALLOC = 1

LIVE = (os.path.ismount(BPFFS) and os.access(BPFFS, os.W_OK)
        and sb.bpf_available())
live = pytest.mark.skipif(not LIVE, reason="needs CAP_BPF and a writable "
                                           "bpffs")

#: the feature maps the fills carry: (pin name, record dtype, attr)
KINDS = (("flows_extra", binfmt.EXTRA_REC_DTYPE, "extra"),
         ("flows_dns", binfmt.DNS_REC_DTYPE, "dns"),
         ("flows_drops", binfmt.DROPS_REC_DTYPE, "drops"))
ATTRS = tuple(a for _n, _d, a in KINDS)
CAPACITY = 1 << 14


def _unique_eviction(rng, n):
    """Flow events with extra, DNS and drop records, in the integer
    regime, each key once (as a hash map holds it): n rows drawn from 4n
    keys, the repeats dropped."""
    from tests.test_torch_staging import _feed
    ev, f = _feed(rng, n, n_distinct=4 * n, v4_share=0.97)
    f["drops"]["bytes"] = rng.integers(0, 600, n)
    f["drops"]["packets"] = rng.integers(0, 9, n)
    keys = np.ascontiguousarray(ev["key"]).view(np.uint8).reshape(n, 40)
    _u, first = np.unique(keys, axis=0, return_index=True)
    keep = np.sort(first)
    return ev[keep], {k: v[keep] for k, v in f.items()}


def distinct_keys(maps: list) -> int:
    """The rows a drain of `maps` evicts: one a distinct key."""
    keys = np.concatenate([k for k, _v in maps])
    return len(np.unique(keys.view(np.dtype((np.void, 40)))))


def fill(pinned: dict, maps: list) -> None:
    """Write one eviction's contents into the real maps."""
    for (keys, vals), name in zip(maps, ["aggregated_flows"]
                                  + [n for n, _d, _a in KINDS]):
        chip_smoke.bpf_update_batch(pinned[name], keys, vals)


@pytest.fixture
def pinned():
    os.makedirs(PIN_DIR, exist_ok=True)
    created = {}
    try:
        agg = sb.BpfMap.create(BPF_MAP_TYPE_HASH,
                               binfmt.FLOW_KEY_DTYPE.itemsize,
                               binfmt.FLOW_STATS_DTYPE.itemsize, CAPACITY,
                               b"agg")
        created["aggregated_flows"] = agg
        for name, dtype, attr in KINDS:
            created[name] = sb.BpfMap.create(
                BPF_MAP_TYPE_PERCPU_HASH, binfmt.FLOW_KEY_DTYPE.itemsize,
                dtype.itemsize, CAPACITY, attr.encode())
        created["global_counters"] = sb.BpfMap.create(
            BPF_MAP_TYPE_PERCPU_ARRAY, 4, 8, int(GlobalCounter.MAX), b"ctrs")
        for name, m in created.items():
            m.pin(os.path.join(PIN_DIR, name))
        yield created
    finally:
        for m in created.values():
            m.close()
        shutil.rmtree(PIN_DIR, ignore_errors=True)


def _eq(a, b) -> None:
    """Two `EvictedFlows` byte for byte."""
    assert len(a) == len(b)
    assert a.events.tobytes() == b.events.tobytes()
    for attr in ("extra", "dns", "drops", "nevents", "xlat", "quic"):
        x, y = getattr(a, attr), getattr(b, attr)
        assert (x is None) == (y is None), attr
        if x is not None:
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), attr
    assert a.decode_stats["fallback_rows"] == b.decode_stats["fallback_rows"]


def _both(pinned, maps, ours, ref):
    """The reference's drain of `maps`, then the port's of the same."""
    fill(pinned, maps)
    want = ref.lookup_and_delete()
    fill(pinned, maps)
    got = ours.lookup_and_delete()
    return got, want


@live
@pytest.mark.parametrize("lanes", [1, 3])
def test_drains_match_the_reference(pinned, lanes):
    rng = np.random.default_rng(3 + lanes)
    n_cpus = sb.n_possible_cpus()
    ours = tloader.BpfmanFetcher(PIN_DIR, drain_lanes=lanes)
    ref = jloader.BpfmanFetcher(PIN_DIR, drain_lanes=lanes)
    try:
        assert (ours._drain_pool is None) == (lanes == 1)
        assert ours._drain_lanes == ref._drain_lanes == lanes
        assert set(ours._features) == set(ATTRS)
        assert ours.map_capacity() == ref.map_capacity() == CAPACITY
        for n in (1, 700, 2500):
            ev, f = _unique_eviction(rng, n)
            maps = chip_smoke._split_maps(rng, ev, f, n_cpus)
            got, want = _both(pinned, maps, ours, ref)
            _eq(got, want)
            assert got.decode_stats["drain_lanes"] == lanes
            assert len(got) >= len(ev)
            for name in ["aggregated_flows"] + [n for n, _d, _a in KINDS]:
                assert pinned[name].keys() == []
        assert len(ours.lookup_and_delete()) == len(ref.lookup_and_delete())
    finally:
        ours.close()
        ref.close()


@live
def test_consecutive_drains_do_not_alias(pinned):
    """The zero-copy drain views are copied once, at the `EvictedFlows`
    boundary: a later drain through the same cached buffers leaves an
    earlier eviction's arrays as they were (`tests/test_bpfman.py:
    147-188`)."""
    rng = np.random.default_rng(11)
    n_cpus = sb.n_possible_cpus()
    for lanes in (1, 3):
        fetcher = tloader.BpfmanFetcher(PIN_DIR, drain_lanes=lanes)
        try:
            ev, f = _unique_eviction(rng, 50)
            fill(pinned, chip_smoke._split_maps(rng, ev, f, n_cpus))
            first = fetcher.lookup_and_delete()
            snap = [first.events.copy()] + [getattr(first, a).copy()
                                             for a in ATTRS]
            ev2, f2 = _unique_eviction(rng, 50)
            fill(pinned, chip_smoke._split_maps(rng, ev2, f2, n_cpus))
            second = fetcher.lookup_and_delete()
            assert len(second) >= len(ev2)
            assert np.array_equal(first.events, snap[0])
            for a, s in zip(ATTRS, snap[1:]):
                assert np.array_equal(getattr(first, a), s)
        finally:
            fetcher.close()


@live
def test_fused_gate_engages_on_real_maps_and_matches(pinned):
    rng = np.random.default_rng(5)
    n_cpus = sb.n_possible_cpus()
    ours = tloader.BpfmanFetcher(PIN_DIR, drain_lanes=4,
                                 native_pipeline=True)
    ref = jloader.BpfmanFetcher(PIN_DIR, drain_lanes=4,
                                native_pipeline=True)
    seq = tloader.BpfmanFetcher(PIN_DIR, drain_lanes=1)
    try:
        gate = ours._native_gate
        assert gate is not None and gate._lanes == 4
        for i, n in enumerate((300, 2200, 1, 1700)):
            ev, f = _unique_eviction(rng, n)
            maps = chip_smoke._split_maps(rng, ev, f, n_cpus)
            got, want = _both(pinned, maps, ours, ref)
            _eq(got, want)
            path = got.decode_stats["native_path"]
            assert path == want.decode_stats["native_path"]
            assert path == ("chain" if i == 0 else "fused"), path
            if i:
                assert gate._pipe is not None and not gate.disabled
                assert set(got.decode_stats["native"]) == {
                    "drain_s", "merge_s", "join_s", "pack_s"}
            fill(pinned, maps)
            _eq(got, seq.lookup_and_delete())
            assert pinned["aggregated_flows"].keys() == []
        empty = ours.lookup_and_delete()
        assert len(empty) == 0 and empty.decode_stats["native_path"] == \
            "fused"
        assert not gate.disabled
    finally:
        ours.close()
        ref.close()
        seq.close()


@live
def test_exporter_tables_after_one_window_match_the_reference(pinned):
    """The port's exporter fed the port's fused drains, packed with its
    ring's dictionaries at drain time, against the JAX exporter fed the
    reference's fused drains of the same map contents."""
    from netobserv_tpu.datapath import flowpack as jfp
    from tests.test_torch_fused_seam import _exporters
    from tests.test_torch_staging import B, _assert_tables, _Samples

    if not jfp.build_native():
        pytest.skip("the reference's native library does not build here")
    rng = np.random.default_rng(9)
    n_cpus = sb.n_possible_cpus()
    exp, raw, jexp = _exporters()
    raw.close()
    ours = tloader.BpfmanFetcher(PIN_DIR, drain_lanes=4,
                                 native_pipeline=True)
    ref = jloader.BpfmanFetcher(PIN_DIR, drain_lanes=4,
                                native_pipeline=True)
    samples = _Samples()
    try:
        ours.bind_pack_surface(exp.resident_pack_surface())
        ref.bind_pack_surface(jexp.resident_pack_surface())
        paths = []
        for n in (B + 40, 3 * B + 11, 2 * B + 70, 190):
            ev, f = _unique_eviction(rng, n)
            samples.add(f)
            maps = chip_smoke._split_maps(rng, ev, f, n_cpus)
            fill(pinned, maps)
            want = ref.lookup_and_delete()
            fill(pinned, maps)
            got = ours.lookup_and_delete()
            _eq(got, want)
            assert (got.packed is None) == (want.packed is None)
            if got.packed is not None:
                assert got.packed.arena.tobytes() == \
                    want.packed.arena.tobytes()
            paths.append(got.decode_stats["native_path"])
            exp.export_evicted(got)
            jexp.export_evicted(want)
        assert paths == ["chain", "fused", "fused", "fused"]
        with exp._lock:
            exp._drain_pending()
        with jexp._lock:
            jexp._drain_pending_locked()
        _assert_tables(exp.state, jexp._state, "real maps", samples)
        assert exp.ingest_errors == 0
    finally:
        exp.close()
        jexp.close()
        ours.close()
        ref.close()


def _trie_contents(rules_map, peers_map) -> tuple:
    out = []
    for m in (rules_map, peers_map):
        out.append(sorted((k, m.lookup(k)) for k in m.keys()))
    return tuple(out)


def _tries(tag: bytes):
    rules = sb.BpfMap.create(BPF_MAP_TYPE_LPM_TRIE, 20, 40, 16,
                             b"frules" + tag, flags=BPF_F_NO_PREALLOC)
    peers = sb.BpfMap.create(BPF_MAP_TYPE_LPM_TRIE, 20, 1, 16,
                             b"fpeers" + tag, flags=BPF_F_NO_PREALLOC)
    return rules, peers


RULES = ('[{"ip_cidr":"10.0.0.0/8","action":"Accept","protocol":"TCP"},'
         '{"ip_cidr":"10.1.1.1/32","action":"Reject",'
         '"peer_cidr":"192.168.0.0/16"},'
         '{"ip_cidr":"2001:db8::/32","destination_port_range":"80-90",'
         '"sample":4,"peer_ip":"10.9.9.9"}]')


@live
def test_filter_rules_programmed_into_real_lpm_tries(pinned):
    from netobserv_tpu import config as jcfg

    rules_map, peers_map = _tries(b"p")
    rules_map.pin(os.path.join(PIN_DIR, "filter_rules"))
    peers_map.pin(os.path.join(PIN_DIR, "filter_peers"))
    ours = tloader.BpfmanFetcher(PIN_DIR)
    ref = jloader.BpfmanFetcher(PIN_DIR)
    try:
        assert ref.program_filters(jcfg.parse_filter_rules(RULES)) == 3
        want = _trie_contents(rules_map, peers_map)
        for m in (rules_map, peers_map):
            for k in m.keys():
                m.delete(k)
        assert _trie_contents(rules_map, peers_map) == ([], [])
        assert ours.program_filters(tcfg.parse_filter_rules(RULES)) == 3
        assert _trie_contents(rules_map, peers_map) == want
        # longest prefix wins: the /32 host rule beats the /8
        key = struct.pack("<I", 128) + ip_to_16("10.1.1.1")
        host = np.frombuffer(rules_map.lookup(key), binfmt.FILTER_RULE_DTYPE)
        assert int(host[0]["action"]) == 1
        wide = rules_map.lookup(struct.pack("<I", 128)
                                + ip_to_16("10.2.2.2"))
        assert int(np.frombuffer(wide, binfmt.FILTER_RULE_DTYPE)[0]
                   ["proto"]) == 6
        assert rules_map.lookup(struct.pack("<I", 128)
                                + ip_to_16("172.16.0.1")) is None
        # the self-managed fetchers' own tries
        t_rules, t_peers = tloader._create_filter_tries()
        j_rules, j_peers = jloader._create_filter_tries()
        try:
            assert (t_rules.max_entries, t_rules.key_size,
                    t_rules.value_size) == (j_rules.max_entries,
                                            j_rules.key_size,
                                            j_rules.value_size)
            assert tloader._program_filter_tries(
                t_rules, t_peers, tcfg.parse_filter_rules(RULES)) == \
                jloader._program_filter_tries(
                    j_rules, j_peers, jcfg.parse_filter_rules(RULES))
            assert _trie_contents(t_rules, t_peers) == \
                _trie_contents(j_rules, j_peers) == want
        finally:
            for m in (t_rules, t_peers, j_rules, j_peers):
                m.close()
    finally:
        ours.close()
        ref.close()
        rules_map.close()
        peers_map.close()


@live
def test_filter_rules_without_pinned_tries_write_nothing(pinned):
    ours = tloader.BpfmanFetcher(PIN_DIR)
    try:
        assert ours.program_filters(tcfg.parse_filter_rules(RULES)) == 0
    finally:
        ours.close()


@live
def test_counters_scrape_and_reset_as_the_reference(pinned):
    n_cpus = sb.n_possible_cpus()

    def bump():
        for ctr, per_cpu in ((GlobalCounter.FILTER_ACCEPT, (5, 7)),
                             (GlobalCounter.HASHMAP_FAIL_UPDATE_DNS, (3,))):
            vals = bytearray(8 * n_cpus)
            for c, v in enumerate(per_cpu[:n_cpus]):
                struct.pack_into("<Q", vals, 8 * c, v)
            pinned["global_counters"].update(struct.pack("<I", int(ctr)),
                                             bytes(vals))

    ours = tloader.BpfmanFetcher(PIN_DIR)
    ref = jloader.BpfmanFetcher(PIN_DIR)
    try:
        bump()
        want = {int(k): v for k, v in ref.read_global_counters().items()}
        assert want[int(GlobalCounter.FILTER_ACCEPT)] == (
            12 if n_cpus > 1 else 5)
        assert ref.read_global_counters() == {}
        bump()
        got = ours.read_global_counters()
        assert {int(k): v for k, v in got.items()} == want
        assert all(isinstance(k, GlobalCounter) for k in got)
        assert ours.read_global_counters() == {}
    finally:
        ours.close()
        ref.close()


@live
def test_dns_stale_purge(pinned):
    dns_map = sb.BpfMap.create(1, tloader.BpfmanFetcher.DNS_CORR_KEY_SIZE, 8,
                               64, b"dnsq")
    dns_map.pin(os.path.join(PIN_DIR, "dns_inflight"))
    fetcher = tloader.BpfmanFetcher(PIN_DIR)
    try:
        now = time.clock_gettime_ns(time.CLOCK_MONOTONIC)
        stale, fresh = b"\x01" * 40, b"\x02" * 40
        dns_map.update(stale, struct.pack("<Q", now - 60 * 10**9))
        dns_map.update(fresh, struct.pack("<Q", now))
        assert fetcher.purge_stale(5.0) == 1
        assert dns_map.lookup(stale) is None
        assert dns_map.lookup(fresh) is not None
        assert fetcher.purge_stale(5.0) == 0
        assert fetcher._rtt_inflight is None
    finally:
        fetcher.close()
        dns_map.close()


@live
def test_ringbuf_reader_opens_and_times_out(pinned):
    rb = sb.BpfMap.create(27, 0, 0, 4096, b"rb")
    rb.pin(os.path.join(PIN_DIR, "direct_flows"))
    try:
        fetcher = tloader.BpfmanFetcher(PIN_DIR)
        assert fetcher._ringbuf is not None and fetcher._ssl_rb is None
        t0 = time.monotonic()
        assert fetcher.read_ringbuf(0.1) is None
        assert fetcher.read_ssl(0.05) is None
        assert time.monotonic() - t0 < 2.0
        fetcher.close()
    finally:
        rb.close()


def test_missing_maps_raise_as_the_reference(tmp_path):
    """EBPF_PROGRAM_MANAGER_MODE over a directory with no pinned maps:
    both fetchers raise the same `OSError` (no bpf(2) rights needed: the
    object lookup fails either way)."""
    errs = []
    for mod in (jloader, tloader):
        with pytest.raises(OSError) as exc:
            mod.BpfmanFetcher(str(tmp_path))
        errs.append(exc.value.errno)
    assert errs[0] == errs[1] and errs[0] in (errno.ENOENT, errno.EPERM,
                                             errno.EINVAL, errno.ENOTSUP)


def test_agent_builds_the_bpfman_fetcher_from_the_environment(tmp_path,
                                                              monkeypatch):
    """`build_fetcher` with EBPF_PROGRAM_MANAGER_MODE and no DATAPATH goes
    to `BpfmanFetcher.load`, which raises over a directory without maps
    as the reference's does. Without it, unset, `auto` and `kernel`
    DATAPATH take the reference's ladder to the same rung under the same
    forced failures: the first kernel rung, else the minimal one, else
    synthetic replay, except that `kernel` raises the last rung's error
    (both rungs are stubbed, so nothing loads or attaches)."""
    from netobserv_tpu import config as jcfg
    from netobserv_tpu.agent import agent as jagent
    from netobserv_tpu.datapath import replay as jreplay
    from netobserv_tpu_torch.agent import agent as tagent
    from netobserv_tpu_torch.datapath import replay as treplay

    monkeypatch.delenv("DATAPATH", raising=False)
    env = {"EXPORT": "tpu-sketch", "EBPF_PROGRAM_MANAGER_MODE": "true",
           "BPFMAN_BPF_FS_PATH": str(tmp_path),
           "EVICT_NATIVE_PIPELINE": "true"}
    cfg = tcfg.load_config(env)
    cfg.validate()
    calls = []
    real = tloader.BpfmanFetcher.load.__func__

    def load(cls, c):
        calls.append((c.bpfman_bpf_fs_path, c.evict_native_pipeline))
        return real(cls, c)

    monkeypatch.setattr(tloader.BpfmanFetcher, "load", classmethod(load))
    with pytest.raises(OSError) as got:
        tagent.build_fetcher(cfg)
    assert calls == [(str(tmp_path), True)]
    with pytest.raises(OSError) as want:
        jagent.build_fetcher(jcfg.load_config(env))
    assert got.value.errno == want.value.errno

    def rung(outcome):
        def load(cls, c):
            if isinstance(outcome, Exception):
                raise outcome
            return outcome
        return classmethod(load)

    def reached(mod_agent, mod_loader, mod_replay, cfg_mod, first, minimal):
        monkeypatch.setattr(mod_loader.KernelFetcher, "load", rung(first))
        monkeypatch.setattr(mod_loader.MinimalKernelFetcher, "load",
                            rung(minimal))
        try:
            out = mod_agent.build_fetcher(
                cfg_mod.load_config({"EXPORT": "tpu-sketch"}))
        except Exception as exc:
            return ("raised", type(exc).__name__, str(exc))
        if isinstance(out, mod_replay.SyntheticFetcher):
            return ("synthetic",)
        return ("fetcher", out)

    cases = [("first", "minimal"), (RuntimeError("no root"), "minimal"),
             (OSError(38, "Function not implemented"), "minimal"),
             (RuntimeError("no root"), RuntimeError("no root")),
             (OSError(38, "ENOSYS"), OSError(38, "Function not implemented"))]
    for mode in (None, "auto", "kernel"):
        if mode is None:
            monkeypatch.delenv("DATAPATH", raising=False)
        else:
            monkeypatch.setenv("DATAPATH", mode)
        for first, minimal in cases:
            got = reached(tagent, tloader, treplay, tcfg, first, minimal)
            want = reached(jagent, jloader, jreplay, jcfg, first, minimal)
            assert got == want, (mode, first, minimal)
            if not isinstance(first, Exception):
                assert got == ("fetcher", "first")
            elif not isinstance(minimal, Exception):
                assert got == ("fetcher", "minimal")
            elif mode == "kernel":
                assert got == ("raised", type(minimal).__name__,
                               str(minimal))
            else:
                assert got == ("synthetic",)


class _Collect:
    name = "collect"

    def __init__(self):
        import queue
        self.batches = queue.Queue()

    def export_batch(self, records):
        self.batches.put(records)

    def close(self):
        pass


def test_agent_programs_flow_filters_on_a_fetcher_that_takes_them():
    """FLOW_FILTER_RULES reaches `program_filters` with the parsed rules
    (reference `agent.py:170-171`); a fetcher without the hook is left
    alone."""
    from netobserv_tpu_torch.agent import FlowsAgent
    from netobserv_tpu_torch.datapath.fetcher import FakeFetcher

    class Filtering(FakeFetcher):
        def __init__(self):
            super().__init__()
            self.programmed = []

        def program_filters(self, rules):
            self.programmed.append(rules)
            return len(rules)

    cfg = tcfg.load_config({"EXPORT": "stdout", "FLOW_FILTER_RULES": RULES})
    cfg.validate()
    f = Filtering()
    FlowsAgent(cfg, f, _Collect())
    assert f.programmed == [cfg.parsed_filter_rules()]
    assert len(f.programmed[0]) == 3
    FlowsAgent(cfg, FakeFetcher(), _Collect())  # no hook: nothing called
    f2 = Filtering()
    FlowsAgent(tcfg.load_config({"EXPORT": "stdout"}), f2, _Collect())
    assert f2.programmed == []


@live
def test_bpfman_agent_pipeline(pinned):
    """The port's agent over the port's `BpfmanFetcher.load(cfg)` exports
    what the pinned aggregation map holds (`tests/test_bpfman.py:
    235-263`)."""
    from netobserv_tpu_torch.agent import FlowsAgent

    key = np.zeros(1, binfmt.FLOW_KEY_DTYPE)[0]
    key["src_ip"] = np.frombuffer(ip_to_16("10.7.7.1"), np.uint8)
    key["dst_ip"] = np.frombuffer(ip_to_16("10.7.7.2"), np.uint8)
    key["src_port"], key["dst_port"], key["proto"] = 2001, 443, 6
    stats = np.zeros(1, binfmt.FLOW_STATS_DTYPE)[0]
    now = time.clock_gettime_ns(time.CLOCK_MONOTONIC)
    stats["bytes"], stats["packets"] = 7777, 9
    stats["first_seen_ns"], stats["last_seen_ns"] = now - 10**9, now
    stats["eth_protocol"], stats["if_index_first"] = 0x0800, 2
    pinned["aggregated_flows"].update(key.tobytes(), stats.tobytes())
    cfg = tcfg.load_config({
        "EXPORT": "stdout", "CACHE_ACTIVE_TIMEOUT": "100ms",
        "EBPF_PROGRAM_MANAGER_MODE": "true", "BPFMAN_BPF_FS_PATH": PIN_DIR,
        "AGENT_IP": "127.0.0.1"})
    out = _Collect()
    agent = FlowsAgent(cfg, tloader.BpfmanFetcher.load(cfg), out)
    stop = threading.Event()
    t = threading.Thread(target=agent.run, args=(stop,), daemon=True)
    t.start()
    try:
        batch = out.batches.get(timeout=5)
        assert len(batch) == 1
        rec = batch[0]
        assert (rec.key.src, rec.key.src_port) == ("10.7.7.1", 2001)
        assert (rec.bytes_, rec.packets) == (7777, 9)
    finally:
        stop.set()
        t.join(timeout=5)
    assert not t.is_alive()


@live
def test_cli_in_bpfman_mode_drains_pinned_maps_through_the_gate(pinned):
    """`python -m netobserv_tpu_torch` with EBPF_PROGRAM_MANAGER_MODE and
    EVICT_NATIVE_PIPELINE on the CPU: the maps are filled while it runs,
    its gate engages, its window reports count every flow of the fills,
    and SIGTERM stops it with exit 0."""
    rng = np.random.default_rng(13)
    n_cpus = sb.n_possible_cpus()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("SKETCH_", "DATAPATH", "EXPORT"))}
    env.update(PYTHONPATH=str(ROOT), AGENT_IP="127.0.0.1",
               SKETCH_DEVICES="cpu", EXPORT="tpu-sketch",
               CACHE_ACTIVE_TIMEOUT="200ms", SKETCH_BATCH_SIZE="256",
               SKETCH_WINDOW="1s", EBPF_PROGRAM_MANAGER_MODE="true",
               BPFMAN_BPF_FS_PATH=PIN_DIR, EVICT_NATIVE_PIPELINE="true",
               EVICT_DRAIN_LANES="2", SKETCH_PACK_THREADS="2")
    proc = subprocess.Popen([sys.executable, "-m", "netobserv_tpu_torch"],
                            cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)
    fed = 0
    reports, buf = [], b""
    try:
        os.set_blocking(proc.stdout.fileno(), False)
        sel = selectors.DefaultSelector()
        sel.register(proc.stdout, selectors.EVENT_READ)
        deadline = time.monotonic() + 60
        fills = 0
        while time.monotonic() < deadline and proc.poll() is None:
            if fills < 6:
                ev, f = _unique_eviction(rng, 400)
                maps = chip_smoke._split_maps(rng, ev, f, n_cpus)
                fill(pinned, maps)
                fed += distinct_keys(maps)
                fills += 1
            if sel.select(timeout=0.3):
                buf += proc.stdout.read() or b""
            *lines, buf = buf.split(b"\n")
            reports += [json.loads(x) for x in lines if x.strip()]
            if fills == 6 and sum(r.get("Records", 0) for r in reports) \
                    >= fed:
                break
        sel.close()
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    reports += [json.loads(x) for x in (buf + out).split(b"\n") if x.strip()]
    text = err.decode(errors="replace")
    assert proc.returncode == 0, text[-3000:]
    assert "native evict pipeline engaged" in text, text[-3000:]
    assert "native evict pipeline disabled" not in text, text[-3000:]
    assert sum(r.get("Records", 0) for r in reports) == fed, (
        [r.get("Records") for r in reports], fed)


def test_batch_update_helper_refuses_a_mismatched_layout():
    """`chip_smoke.bpf_update_batch` checks its arrays against the map
    before any syscall."""
    class M:
        fd, key_size, value_size, n_cpus, percpu = -1, 40, 104, 1, False

    with pytest.raises(ValueError):
        chip_smoke.bpf_update_batch(M(), np.zeros((3, 40), np.uint8),
                                    np.zeros((2, 1), binfmt.FLOW_STATS_DTYPE))
    with pytest.raises(ValueError):
        chip_smoke.bpf_update_batch(M(), np.zeros((3, 39), np.uint8),
                                    np.zeros((3, 1), binfmt.FLOW_STATS_DTYPE))
    chip_smoke.bpf_update_batch(M(), np.zeros((0, 40), np.uint8),
                                np.zeros((0, 1), binfmt.FLOW_STATS_DTYPE))
    assert jsb.n_possible_cpus() == sb.n_possible_cpus()
