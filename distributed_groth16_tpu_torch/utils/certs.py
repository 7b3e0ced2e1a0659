"""Certificate tooling for the mTLS star — the gen_cert role
(mpc-net/examples/gen_cert.rs) plus ssl-context construction mirroring the
reference's trust model (mpc-net/src/prod.rs:41-78): the king authenticates
clients against a pinned roster of client certs (cert list = membership
roster), clients pin the king's certificate."""

from __future__ import annotations

import datetime
import ipaddress
import ssl

from cryptography import x509
from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import ec
from cryptography.x509.oid import NameOID


def gen_self_signed(
    common_name: str, san_hosts: list[str] | None = None
) -> tuple[bytes, bytes]:
    """Generate a self-signed cert; returns (cert_pem, key_pem)."""
    key = ec.generate_private_key(ec.SECP256R1())
    name = x509.Name(
        [x509.NameAttribute(NameOID.COMMON_NAME, common_name)]
    )
    sans = []
    for h in san_hosts or ["localhost", "127.0.0.1"]:
        try:
            sans.append(x509.IPAddress(ipaddress.ip_address(h)))
        except ValueError:
            sans.append(x509.DNSName(h))
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=365))
        .add_extension(x509.SubjectAlternativeName(sans), critical=False)
        .sign(key, hashes.SHA256())
    )
    cert_pem = cert.public_bytes(serialization.Encoding.PEM)
    key_pem = key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption(),
    )
    return cert_pem, key_pem


def king_ssl_context(
    cert_file: str, key_file: str, client_cert_files: list[str]
) -> ssl.SSLContext:
    """Server-side mTLS: require a client cert from the roster
    (AllowAnyAuthenticatedClient over the pinned store, prod.rs:41-59)."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert_file, key_file)
    ctx.verify_mode = ssl.CERT_REQUIRED
    for f in client_cert_files:
        ctx.load_verify_locations(f)
    return ctx


def peer_ssl_context(
    cert_file: str, key_file: str, king_cert_file: str
) -> ssl.SSLContext:
    """Client-side mTLS: present our identity, pin the king's cert
    (prod.rs:159-184)."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.load_cert_chain(cert_file, key_file)
    ctx.load_verify_locations(king_cert_file)
    ctx.check_hostname = False  # identity = pinned cert, not hostname
    return ctx


def main(argv=None) -> None:
    """CLI: python -m distributed_groth16_tpu.utils.certs NAME OUT_DIR"""
    import argparse
    import os

    p = argparse.ArgumentParser(description="generate a self-signed cert")
    p.add_argument("name")
    p.add_argument("out_dir")
    p.add_argument("--host", action="append", default=None)
    a = p.parse_args(argv)
    cert, key = gen_self_signed(a.name, a.host)
    os.makedirs(a.out_dir, exist_ok=True)
    cert_path = os.path.join(a.out_dir, f"{a.name}.cert.pem")
    key_path = os.path.join(a.out_dir, f"{a.name}.key.pem")
    open(cert_path, "wb").write(cert)
    open(key_path, "wb").write(key)
    print(cert_path)
    print(key_path)


if __name__ == "__main__":
    main()
