"""Artifact server + transfer client tests (reference: runMserver.cpp routes
:237-285, msend retries helper_fns.sh:56-61, metrics CSVs §5.1)."""

import csv
import os

import pytest

from ppqsflhe.comm.client import CommClient
from ppqsflhe.comm.server import ArtifactServer


@pytest.fixture()
def server(tmp_path):
    storage = str(tmp_path / "storage")
    os.makedirs(storage)
    with open(os.path.join(storage, "CC.json"), "w") as f:
        f.write('{"format": "test-cc"}')
    srv = ArtifactServer(storage, port=0,
                         metrics_csv=str(tmp_path / "server_metrics.csv")).start()
    yield srv, storage, str(tmp_path)
    srv.stop()


def test_get_cc_and_download(server, tmp_path):
    srv, storage, root = server
    c = CommClient(f"http://127.0.0.1:{srv.port}", role="client_1",
                   metrics_csv=os.path.join(root, "client_metrics.csv"))
    dest = str(tmp_path / "cc_local.json")
    c.get("/getCC", dest)
    assert open(dest).read() == '{"format": "test-cc"}'

    os.makedirs(os.path.join(storage, "client_1"), exist_ok=True)
    with open(os.path.join(storage, "client_1", "blob.bin"), "wb") as f:
        f.write(b"\x01\x02\x03" * 1000)
    dest2 = str(tmp_path / "blob.bin")
    c.get("/download/client_1/blob.bin", dest2)
    assert os.path.getsize(dest2) == 3000


def test_download_path_traversal_rejected(server, tmp_path):
    """/download must never serve outside the storage root (the reference
    joins under server/storage — runMserver.cpp:189-234; we must too)."""
    import urllib.error
    import urllib.request

    srv, storage, root = server
    # a secret OUTSIDE the storage root
    with open(os.path.join(root, "secret.txt"), "w") as f:
        f.write("credentials")
    for path in ("/download/../secret.txt",
                 "/download/..%2Fsecret.txt",
                 "/download/client_1/../../secret.txt"):
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}{path}", timeout=10) as r:
                body = r.read()
                assert b"credentials" not in body, path
        except urllib.error.HTTPError as e:
            assert e.code in (403, 404), (path, e.code)


def test_bad_ciphertext_magic():
    from ppqsflhe.ckks import serialize as ser

    with pytest.raises(ValueError, match="magic"):
        ser.ciphertext_from_bytes(b"XXXX" + b"\x00" * 64)


def test_ciphertext_wire_v2_packing():
    """v2 wire format packs each limb at its minimal byte width (reference
    chain 60/40/40/20-bit → 8/5/5/3 B ≈ 34% smaller than v1); v1 blobs
    stay readable."""
    import numpy as np
    import jax.numpy as jnp

    from ppqsflhe.ckks import serialize as ser
    from ppqsflhe.ckks.types import Ciphertext

    rng = np.random.default_rng(0)
    moduli = [1152921504606748673, 1099510054913, 1099511922689, 557057]
    data = np.stack([
        np.stack([rng.integers(0, q, 512, dtype=np.uint64) for q in moduli])
        for _ in range(2)
    ])
    ct = Ciphertext(jnp.asarray(data), scale=2.0 ** 40)
    b2 = ser.ciphertext_to_bytes(ct)
    b1 = ser.ciphertext_to_bytes(ct, version=1)
    assert len(b2) < 0.70 * len(b1)
    for blob in (b1, b2):
        back = ser.ciphertext_from_bytes(blob)
        assert np.array_equal(np.asarray(back.data), data)
        assert back.scale == ct.scale


def test_upload_multipart_and_metrics(server, tmp_path):
    srv, storage, root = server
    mcsv = os.path.join(root, "client_metrics.csv")
    c = CommClient(f"http://127.0.0.1:{srv.port}", role="client_2", metrics_csv=mcsv)
    payload = str(tmp_path / "enc_weights.json")
    with open(payload, "w") as f:
        f.write('{"weights_summary": []}')
    c.post_file("/uploadEncWeightsC2", payload, client_id="client_2", type_="enc_weights")
    stored = os.path.join(storage, "client_2", "enc_weights.json")
    assert os.path.exists(stored)
    assert open(stored).read() == '{"weights_summary": []}'
    # metrics CSV has the reference's 12-column schema
    with open(mcsv) as f:
        rows = list(csv.reader(f))
    assert rows[0][:4] == ["timestamp", "role", "method", "endpoint"]
    assert len(rows) >= 2 and rows[-1][1] == "client_2"


def test_pubkey_route(server, tmp_path):
    srv, storage, root = server
    c = CommClient(f"http://127.0.0.1:{srv.port}")
    pk = str(tmp_path / "client_1-public.key")
    with open(pk, "w") as f:
        f.write("PUBKEY1")
    c.post_file("/uploadPubKeyC1", pk, client_id="client_1", type_="pubkey")
    dest = str(tmp_path / "fetched.key")
    c.get("/sendPbKeyC1", dest)
    assert open(dest).read() == "PUBKEY1"


def test_local_mode(tmp_path):
    """COMM_MODE != MONGOOSE cp fallback (comm_fns.sh:14-18)."""
    storage = str(tmp_path / "srv")
    os.makedirs(storage)
    with open(os.path.join(storage, "CC.json"), "w") as f:
        f.write("CC")
    c = CommClient(mode="local", local_storage_root=storage)
    dest = str(tmp_path / "cc.json")
    c.get("/getCC", dest)
    assert open(dest).read() == "CC"
    up = str(tmp_path / "w.json")
    with open(up, "w") as f:
        f.write("W")
    c.post_file("/uploadEncWeightsC1", up)
    assert open(os.path.join(storage, "client_1", "w.json")).read() == "W"


def test_get_retries_then_fails(tmp_path):
    c = CommClient("http://127.0.0.1:9", role="x")  # closed port
    import ppqsflhe.comm.client as cl

    orig = cl.BACKOFF_S
    cl.BACKOFF_S = 0.01
    try:
        with pytest.raises(ConnectionError):
            c.get("/getCC", str(tmp_path / "nope"))
    finally:
        cl.BACKOFF_S = orig
