"""Native C++ runtime components: build, serde codec, artifact server
(reference analogues: runMserver.cpp, base64_utils.h)."""

import os
import shutil
import subprocess
import time
import urllib.request

import pytest

from ppqsflhe.runtime.native import NativeSerde, build_native, native_server_binary

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")


@pytest.fixture(scope="module", autouse=True)
def built():
    assert build_native(), "native build failed"


def test_serde_roundtrip():
    s = NativeSerde()
    assert s.is_native
    import base64
    import os as _os

    for n in (0, 1, 2, 3, 57, 1000, 65537):
        data = _os.urandom(n)
        enc = s.encode(data)
        assert enc == base64.b64encode(data).decode()
        assert s.decode(enc) == data


def test_serde_ciphertext_blob():
    """Framing interop with ckks.serialize's Base64 wrapping."""
    import numpy as np
    import jax.numpy as jnp

    from ppqsflhe.ckks import serialize as ser
    from ppqsflhe.ckks.types import Ciphertext

    ct = Ciphertext(jnp.asarray(np.arange(2 * 2 * 8, dtype=np.uint64).reshape(2, 2, 8)),
                    scale=2.0**40)
    blob = ser.ciphertext_to_bytes(ct)
    s = NativeSerde()
    assert s.decode(s.encode(blob)) == blob
    back = ser.ciphertext_from_bytes(s.decode(s.encode(blob)))
    assert (np.asarray(back.data) == np.asarray(ct.data)).all()


def test_native_server_end_to_end(tmp_path):
    binary = native_server_binary()
    assert binary
    storage = str(tmp_path / "storage")
    os.makedirs(storage)
    with open(os.path.join(storage, "CC.json"), "w") as f:
        f.write('{"cc": 1}')
    proc = subprocess.Popen([binary, storage, "0"],
                            stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline().strip()
        assert line.startswith("LISTENING ")
        port = int(line.split()[1])
        base = f"http://127.0.0.1:{port}"
        # GET /getCC
        with urllib.request.urlopen(base + "/getCC", timeout=5) as r:
            assert r.read() == b'{"cc": 1}'
        # POST multipart upload through the Python comm client
        from ppqsflhe.comm.client import CommClient

        c = CommClient(base, role="client_1")
        payload = str(tmp_path / "w.json")
        with open(payload, "w") as f:
            f.write("WEIGHTS" * 1000)
        c.post_file("/uploadEncWeightsC1", payload, client_id="client_1", type_="w")
        stored = os.path.join(storage, "client_1", "w.json")
        assert os.path.exists(stored)
        assert open(stored).read() == "WEIGHTS" * 1000
        # GET /download round-trip
        dest = str(tmp_path / "back.json")
        c.get("/download/client_1/w.json", dest)
        assert open(dest).read() == "WEIGHTS" * 1000
        # pubkey route
        pk = str(tmp_path / "client_2-public.key")
        with open(pk, "w") as f:
            f.write("PK2")
        c.post_file("/uploadPubKeyC2", pk, client_id="client_2", type_="pubkey")
        with urllib.request.urlopen(base + "/sendPbKeyC2", timeout=5) as r:
            assert r.read() == b"PK2"
    finally:
        proc.terminate()
        proc.wait(timeout=5)
