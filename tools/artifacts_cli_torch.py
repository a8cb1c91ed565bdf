"""Artifact distribution CLI: manifest generation + pinned mirroring, over
the PyTorch port's file fetch layer (zksc_tpu_torch.file_fetch).

Script-parity with the reference's artifact tooling
(js/src/scripts/download-files.ts:25-56 — zip-from-GitHub mirror — and the
publish flow): here `manifest` hashes a local artifact tree into a pinned
manifest (the publish half: the manifest IS the integrity pin set that a
release ships), and `download` mirrors a manifest from a remote base URL or
another directory with per-file SHA-256 verification.

Usage:
  python tools/artifacts_cli_torch.py manifest ARTIFACT_DIR [-o manifest.json]
  python tools/artifacts_cli_torch.py download --manifest manifest.json \
      --dest DIR (--base-url URL | --from-dir DIR)
  python tools/artifacts_cli_torch.py publish ARTIFACT_DIR -o release.zip
"""
import argparse
import hashlib
import json
import os
import sys
import zipfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from zksc_tpu_torch.file_fetch import (  # noqa: E402
    make_local_file_fetch, make_remote_file_fetch, mirror_artifacts,
)


def build_manifest(root: str) -> dict:
    """{engine: {filename: sha256_hex}} for every file under root/engine/."""
    manifest = {}
    for engine in sorted(os.listdir(root)):
        edir = os.path.join(root, engine)
        if not os.path.isdir(edir):
            continue
        files = {}
        for name in sorted(os.listdir(edir)):
            path = os.path.join(edir, name)
            if os.path.isfile(path):
                with open(path, "rb") as f:
                    files[name] = hashlib.sha256(f.read()).hexdigest()
        if files:
            manifest[engine] = files
    return manifest


def publish(root: str, out_path: str) -> dict:
    """Package an artifact tree + its pinned manifest into one release zip
    (the shape js/src/scripts/download-files.ts:25-56 unpacks: engine-dir
    entries plus a manifest.json whose hashes pin every member)."""
    manifest = build_manifest(root)
    with zipfile.ZipFile(out_path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("manifest.json",
                   json.dumps(manifest, indent=2, sort_keys=True) + "\n")
        for engine, files in manifest.items():
            for name in files:
                z.write(os.path.join(root, engine, name),
                        arcname=f"{engine}/{name}")
    return manifest


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    m = sub.add_parser("manifest", help="hash an artifact tree into a "
                                        "pinned manifest")
    m.add_argument("root")
    m.add_argument("-o", "--out", default="-")
    d = sub.add_parser("download", help="mirror a pinned manifest locally")
    d.add_argument("--manifest", required=True)
    d.add_argument("--dest", required=True)
    src = d.add_mutually_exclusive_group(required=True)
    src.add_argument("--base-url")
    src.add_argument("--from-dir")
    p = sub.add_parser("publish", help="zip an artifact tree + manifest "
                                       "into a release archive")
    p.add_argument("root")
    p.add_argument("-o", "--out", required=True)
    args = ap.parse_args(argv)

    if args.cmd == "publish":
        manifest = publish(args.root, args.out)
        n = sum(len(f) for f in manifest.values())
        print(f"published {n} files ({', '.join(sorted(manifest))}) "
              f"-> {args.out}")
        return 0

    if args.cmd == "manifest":
        manifest = build_manifest(args.root)
        text = json.dumps(manifest, indent=2, sort_keys=True)
        if args.out == "-":
            print(text)
        else:
            with open(args.out, "w") as f:
                f.write(text + "\n")
        return 0

    with open(args.manifest) as f:
        manifest = json.load(f)
    fetcher = (make_remote_file_fetch(args.base_url) if args.base_url
               else make_local_file_fetch(args.from_dir))
    written = mirror_artifacts(fetcher, manifest, args.dest)
    print(f"mirrored {len(written)} files to {args.dest}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
