"""The JAX package's last untouched test files, run on the port.

Each file is compiled with every ``asciichat_tpu.`` import retargeted to
``asciichat_tpu_torch.`` (``test_torch_webrtc.port_jax_tests``), so its
cases are the same code and keep their names: the encryption and key
exchange (``test_crypto.py``), the codecs and error strings
(``test_codecs_errors.py``), the round-5 review cases
(``test_review_r05.py``), the renderer fuzz on the plain versions
(``test_fuzz_render.py``), ACIP packets (``test_packet.py``) and the SSH,
GPG and HTTPS-forge key authentication (``test_sshauth.py``,
``test_gpgauth.py``, ``test_httpskeys.py``).

``ASCIICHAT_TORCH_DEVICE=cpu`` is set while this module's tests run (and
restored after), so the port's servers that they start, in process or as
a subprocess, serve on the plain versions.
"""

import pytest

from test_torch_webrtc import port_jax_tests


@pytest.fixture(autouse=True, scope="module")
def _plain_device():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ASCIICHAT_TORCH_DEVICE", "cpu")
        yield


for _name in ("test_crypto.py", "test_codecs_errors.py", "test_review_r05.py",
              "test_fuzz_render.py", "test_packet.py", "test_sshauth.py",
              "test_gpgauth.py", "test_httpskeys.py"):
    port_jax_tests(globals(), _name)
