"""Crypto utilities: ssh keypairs, on-node credential protection, ssh
exec helpers.

The port's copy of batch_shipyard_tpu/utils/crypto.py.

Reference analog: convoy/crypto.py — ssh keypair gen (:127), PEM/PFX
cert derivation via openssl subprocess (:219-434), RSA
encrypt/decrypt of credentials for on-node env (:535-615), ssh
connect/exec helper (:171). Re-built on the ``cryptography`` library
(no openssl subprocess needed) with the same capability surface.
"""

from __future__ import annotations

import base64
import os
import subprocess
from typing import Optional, Sequence

# The cryptography wheel is absent from some accelerator containers;
# gate it so importing this module (and everything that transitively
# pulls utils) stays possible — the key/credential helpers raise a
# clear error at CALL time instead.
try:
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import padding, rsa
    HAVE_CRYPTOGRAPHY = True
except ImportError:  # pragma: no cover - environment-dependent
    hashes = serialization = padding = rsa = None
    HAVE_CRYPTOGRAPHY = False


def _require_cryptography() -> None:
    if not HAVE_CRYPTOGRAPHY:
        raise RuntimeError(
            "the 'cryptography' package is not installed in this "
            "environment; ssh keypair / credential encryption "
            "helpers are unavailable")

from batch_shipyard_tpu_torch.utils import util

logger = util.get_logger(__name__)


def generate_ssh_keypair(output_dir: str,
                         name: str = "id_rsa_shipyard",
                         bits: int = 3072) -> tuple[str, str]:
    """Generate an RSA ssh keypair; returns (private_path,
    public_path). (reference crypto.py:127)"""
    _require_cryptography()
    key = rsa.generate_private_key(public_exponent=65537, key_size=bits)
    private_pem = key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.OpenSSH,
        serialization.NoEncryption())
    public_ssh = key.public_key().public_bytes(
        serialization.Encoding.OpenSSH,
        serialization.PublicFormat.OpenSSH)
    os.makedirs(output_dir, exist_ok=True)
    private_path = os.path.join(output_dir, name)
    public_path = private_path + ".pub"
    with open(private_path, "wb") as fh:
        fh.write(private_pem)
    os.chmod(private_path, 0o600)
    with open(public_path, "wb") as fh:
        fh.write(public_ssh + b"\n")
    return private_path, public_path


def generate_rsa_keypair_pem(bits: int = 3072) -> tuple[bytes, bytes]:
    """(private_pem, public_pem) for credential encryption."""
    _require_cryptography()
    key = rsa.generate_private_key(public_exponent=65537, key_size=bits)
    private_pem = key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption())
    public_pem = key.public_key().public_bytes(
        serialization.Encoding.PEM,
        serialization.PublicFormat.SubjectPublicKeyInfo)
    return private_pem, public_pem


def encrypt_credential(public_pem: bytes, plaintext: str) -> str:
    """RSA-OAEP encrypt a short credential for on-node decryption
    (reference crypto.py:535 encrypt via cert)."""
    _require_cryptography()
    public = serialization.load_pem_public_key(public_pem)
    ciphertext = public.encrypt(
        plaintext.encode("utf-8"),
        padding.OAEP(mgf=padding.MGF1(hashes.SHA256()),
                     algorithm=hashes.SHA256(), label=None))
    return base64.b64encode(ciphertext).decode("ascii")


def decrypt_credential(private_pem: bytes, encrypted_b64: str) -> str:
    _require_cryptography()
    private = serialization.load_pem_private_key(private_pem, None)
    plaintext = private.decrypt(
        base64.b64decode(encrypted_b64),
        padding.OAEP(mgf=padding.MGF1(hashes.SHA256()),
                     algorithm=hashes.SHA256(), label=None))
    return plaintext.decode("utf-8")


def ssh_command(ip: str, port: int = 22, username: str = "shipyard",
                private_key_file: Optional[str] = None,
                command: Optional[str] = None,
                extra_options: Sequence[str] = (),
                host_key_checking: str = "accept-new") -> list[str]:
    """Build an ssh argv (reference crypto.py:171 connect helper).

    host_key_checking: OpenSSH StrictHostKeyChecking value. The
    default 'accept-new' is trust-on-first-use — unlike the
    reference's unconditional 'no', a changed host key (MITM) is
    rejected; pass 'no' explicitly for throwaway nodes.
    """
    argv = ["ssh", "-o", f"StrictHostKeyChecking={host_key_checking}",
            "-p", str(port)]
    if host_key_checking == "no":
        argv[3:3] = ["-o", "UserKnownHostsFile=/dev/null"]
    if private_key_file:
        argv += ["-i", private_key_file]
    argv += list(extra_options)
    argv.append(f"{username}@{ip}")
    if command:
        argv.append(command)
    return argv


def ssh_exec(ip: str, command: str, port: int = 22,
             username: str = "shipyard",
             private_key_file: Optional[str] = None,
             timeout: float = 60.0) -> tuple[int, str, str]:
    argv = ssh_command(ip, port, username, private_key_file, command)
    return util.subprocess_capture(argv, timeout=timeout)


def ssh_tunnel_script(ip: str, port: int, local_port: int,
                      remote_port: int, username: str,
                      private_key_file: Optional[str],
                      output_path: str) -> str:
    """Write an ssh tunnel helper script (reference batch.py:1095 ssh
    tunnel script gen; used for tensorboard/grafana tunnels)."""
    key_arg = f"-i {private_key_file} " if private_key_file else ""
    script = (
        "#!/usr/bin/env bash\n"
        "set -e\n"
        f"exec ssh -o StrictHostKeyChecking=accept-new "
        f"{key_arg}-p {port} "
        f"-N -L {local_port}:localhost:{remote_port} "
        f"{username}@{ip}\n")
    with open(output_path, "w", encoding="utf-8") as fh:
        fh.write(script)
    os.chmod(output_path, 0o755)
    return output_path
