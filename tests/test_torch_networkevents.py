"""The port's network-events decoding (netobserv_tpu_torch/utils/
networkevents.py, ovn_decoder.py, net.py, model/tls_types.py and the
agent's ENABLE_NETWORK_EVENTS_MONITORING branch) against the JAX
package's, a twin of `tests/test_networkevents.py`.

- `decode_cookie` and `is_drop_event` give the reference's answers on
  the named cookies and on 500 seeded ones.
- `OvsdbSampleDecoder` against the reference's fake OVSDB socket server
  enriches as the reference's does, keeps its cache after the server
  goes, and degrades to the static decode without a socket;
  `set_decoder` plugs a decoder in and None restores the static one;
  `make_decoder` picks the socket-backed decoder only where the socket
  exists.
- The agent with ENABLE_NETWORK_EVENTS_MONITORING installs the decoder
  `make_decoder` picks and, at shutdown, closes it and restores the
  static one, as the reference's agent does.
- `utils/net` and `model/tls_types` render as the reference's.
"""

from __future__ import annotations

import os
import tempfile
import threading

import numpy as np
import pytest

from netobserv_tpu import config as jcfg
from netobserv_tpu.model import tls_types as jtls
from netobserv_tpu.utils import net as jnet
from netobserv_tpu.utils import networkevents as jne
from netobserv_tpu.utils import ovn_decoder as jovn
from netobserv_tpu.utils import retrace as jretrace
from netobserv_tpu.utils import tracing as jtracing
from netobserv_tpu_torch import config as tcfg
from netobserv_tpu_torch.model import tls_types as ttls
from netobserv_tpu_torch.model.flow import ip_to_16
from netobserv_tpu_torch.utils import net as tnet
from netobserv_tpu_torch.utils import networkevents as tne
from netobserv_tpu_torch.utils import ovn_decoder as tovn
from netobserv_tpu_torch.utils import retrace, tracing
from tests.test_networkevents import _FakeOvsdb, make_cookie


@pytest.fixture(autouse=True)
def _restore_hooks():
    yield
    for mod in (tovn, jovn):
        mod.set_decoder(None)
    for mod in (tracing, retrace, jtracing, jretrace):
        mod.set_metrics(None)


NAMED = [bytes([1, 1, 0, 0]) + (4242).to_bytes(4, "little"),
         b"\x07\x01", bytes([1, 0, 2, 1]) + (7).to_bytes(4, "little"),
         bytes([1, 9, 9, 3]) + (1).to_bytes(4, "little"), b"",
         bytes([1, 1, 1, 0, 0, 0, 0])]


def _seeded_cookies(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        raw = bytearray(rng.integers(0, 256, int(rng.integers(0, 13)),
                                     dtype=np.uint8).tobytes())
        if raw and rng.random() < 0.6:
            raw[0] = 1
            if len(raw) > 1:
                raw[1] = int(rng.integers(0, 5))
        out.append(bytes(raw))
    return out


def test_cookies_decode_as_the_reference():
    cookies = NAMED + _seeded_cookies(233, 500)
    for c in cookies:
        assert tne.decode_cookie(c) == jne.decode_cookie(c), c.hex()
        assert tne.is_drop_event(c) == jne.is_drop_event(c)
    assert tne.decode_cookie(NAMED[0]) == {
        "Feature": "acl", "Action": "drop", "Type": "acl",
        "Direction": "ingress", "Name": "4242"}
    assert tne.decode_cookie(b"\x07\x01") == {"raw": "0701"}


def _serve():
    path = os.path.join(tempfile.mkdtemp(), "ovnnb.sock")
    srv = _FakeOvsdb(path, _FakeOvsdb.Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return path, srv


def _decode_through_server(mod) -> list:
    path, srv = _serve()
    try:
        dec = mod.OvsdbSampleDecoder(sock_path=path)
        out = [dec.decode(make_cookie(obj_id=7)),
               dec.decode(make_cookie(obj_id=99)),
               dec.decode(make_cookie(action=0, direction=0, obj_id=7)),
               dec.decode(b"\x07\x01")]
        srv.shutdown()
        srv.server_close()
        # the cache answers for the known id; a new one degrades
        out += [dec.decode(make_cookie(obj_id=7)),
                dec.decode(make_cookie(obj_id=5))]
        dec.close()
        return out
    finally:
        srv.server_close()


def test_ovsdb_decoder_enriches_as_the_reference():
    got = _decode_through_server(tovn)
    assert got == _decode_through_server(jovn)
    assert got[0]["Name"] == "allow-dns" and got[0]["Namespace"] == "prod"
    assert got[1]["Name"] == "99" and got[4]["Name"] == "allow-dns"
    assert got[5]["Name"] == "5"


def test_ovsdb_decoder_degrades_without_a_socket():
    outs = [mod.OvsdbSampleDecoder(sock_path="/nonexistent/ovn.sock")
            .decode(make_cookie(obj_id=3)) for mod in (tovn, jovn)]
    assert outs[0] == outs[1]
    assert outs[0]["Name"] == "3" and outs[0]["Action"] == "drop"


def test_the_active_decoder_is_pluggable():
    class Custom:
        def decode(self, cookie):
            return {"Message": "custom"}

        def close(self):
            pass

    tovn.set_decoder(Custom())
    assert tovn.decode_event(b"\x01\x01") == {"Message": "custom"}
    assert isinstance(jovn.active_decoder(), jovn.StaticCookieDecoder)
    tovn.set_decoder(None)
    assert isinstance(tovn.active_decoder(), tovn.StaticCookieDecoder)
    assert tovn.decode_event(make_cookie()) == jovn.decode_event(
        make_cookie())


@pytest.mark.parametrize("sock", [False, True])
def test_make_decoder_picks_as_the_reference(monkeypatch, tmp_path, sock):
    path = tmp_path / "ovnnb_db.sock"
    if sock:
        path.write_bytes(b"")
    kinds = []
    for mod in (tovn, jovn):
        monkeypatch.setattr(mod, "OVN_NB_SOCK", str(path))
        kinds.append(type(mod.make_decoder(None)).__name__)
    assert kinds[0] == kinds[1] == ("OvsdbSampleDecoder" if sock
                                    else "StaticCookieDecoder")


class _Collect:
    name = "collect"

    def export_batch(self, records):
        pass

    def close(self):
        pass


def test_the_agent_installs_and_uninstalls_the_decoder(monkeypatch,
                                                       tmp_path):
    from netobserv_tpu.agent.agent import FlowsAgent as JAgent
    from netobserv_tpu.datapath.fetcher import FakeFetcher as JFake
    from netobserv_tpu_torch.agent import FlowsAgent
    from netobserv_tpu_torch.datapath.fetcher import FakeFetcher

    env = {"EXPORT": "tpu-sketch", "ENABLE_NETWORK_EVENTS_MONITORING": "true",
           "NETWORK_EVENTS_MONITORING_GROUP_ID": "10"}
    for mod in (tovn, jovn):
        monkeypatch.setattr(mod, "OVN_NB_SOCK", str(tmp_path / "absent"))
    seen = []
    for cfgm, agent_cls, fake_cls, ovn in (
            (tcfg, FlowsAgent, FakeFetcher, tovn),
            (jcfg, JAgent, JFake, jovn)):
        cfg = cfgm.load_config(env)
        cfg.validate()
        agent = agent_cls(cfg, fake_cls(), _Collect())
        installed = ovn.active_decoder()
        assert installed is agent._ovn_decoder
        stop = threading.Event()
        t = threading.Thread(target=agent.run, args=(stop,), daemon=True)
        t.start()
        stop.set()
        t.join(timeout=10)
        assert not t.is_alive()
        assert agent._ovn_decoder is None
        assert ovn.active_decoder() is not installed
        seen.append((type(installed).__name__,
                     type(ovn.active_decoder()).__name__))
    assert seen[0] == seen[1] == ("StaticCookieDecoder",
                                  "StaticCookieDecoder")


@pytest.mark.parametrize("addr,port", [("10.1.2.3", 80), ("::1", 443),
                                       ("fe80::1:2", 0), ("0.0.0.0", 65535)])
def test_net_formats_as_the_reference(addr, port):
    raw = ip_to_16(addr)
    assert tnet.format_addr_port(raw, port) == jnet.format_addr_port(
        raw, port)
    mac = bytes(range(6, 13))
    assert tnet.format_mac(mac) == jnet.format_mac(mac)


def test_tls_names_are_the_references():
    for v in list(range(0x02FF, 0x0306)) + [0, 0x7F1C]:
        assert ttls.tls_version_name(v) == jtls.tls_version_name(v)
    for c in (0, 0x1301, 0x1302, 0x1303, 0xC02B, 0xC030, 0x00FF):
        assert ttls.cipher_suite_name(c) == jtls.cipher_suite_name(c)
    for g in (0, 0x17, 0x1D, 0x11EC, 0x4242):
        assert ttls.key_share_name(g) == jtls.key_share_name(g)
    for bits in range(64):
        assert ttls.tls_types_names(bits) == jtls.tls_types_names(bits)
