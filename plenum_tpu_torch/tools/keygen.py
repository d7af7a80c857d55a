"""Node key generation CLI.

Reference behavior: scripts/init_plenum_keys + init_bls_keys — derive a
node's Ed25519 transport/steward keys and BLS consensus keys from a seed and
write them under a base dir. Usage:

    python -m plenum_tpu_torch.tools.keygen --name Node1 --base-dir /tmp/pool \
        [--seed <32 chars>] [--json]
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os


def generate_keys(name: str, seed: bytes | None = None) -> dict:
    from plenum_tpu_torch.crypto.bls import BlsCryptoSigner
    from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer

    seed = seed or os.urandom(32)
    assert len(seed) == 32
    node_signer = Ed25519Signer(seed=seed)
    bls_seed = hashlib.sha256(b"bls" + seed).digest()
    bls_signer = BlsCryptoSigner(seed=bls_seed)
    return {
        "name": name,
        "seed": seed.hex(),
        "verkey": node_signer.verkey.hex(),
        "verkey_b58": node_signer.verkey_b58,
        "bls_seed": bls_seed.hex(),
        "bls_pk": bls_signer.pk,
        "bls_pop": bls_signer.generate_pop(),
    }


def save_keys(keys: dict, base_dir: str) -> str:
    """Write <base>/<name>/keys.json 0600; returns the path."""
    node_dir = os.path.join(base_dir, keys["name"])
    os.makedirs(node_dir, exist_ok=True)
    path = os.path.join(node_dir, "keys.json")
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    with os.fdopen(fd, "w") as f:
        json.dump(keys, f, indent=2)
    return path


def load_keys(base_dir: str, name: str) -> dict:
    with open(os.path.join(base_dir, name, "keys.json")) as f:
        return json.load(f)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--name", required=True)
    ap.add_argument("--base-dir", required=True)
    ap.add_argument("--seed", help="32-char seed (default: random)")
    ap.add_argument("--json", action="store_true",
                    help="print full keys as JSON (includes SECRETS)")
    args = ap.parse_args(argv)
    seed = args.seed.encode().ljust(32, b"\0")[:32] if args.seed else None
    keys = generate_keys(args.name, seed)
    path = save_keys(keys, args.base_dir)
    if args.json:
        print(json.dumps(keys))
    else:
        public = {k: keys[k] for k in ("name", "verkey_b58", "bls_pk",
                                       "bls_pop")}
        print(json.dumps({"saved": path, **public}))


if __name__ == "__main__":
    main()
