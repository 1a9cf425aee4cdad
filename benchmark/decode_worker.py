"""Decodes access units for check.decode_each, in a process of its own:

    python3 -m benchmark.decode_worker <dir> <i> [<i> ...]

from the root of a checkout.  Reads <dir>/au<i>.266, each one picture,
and writes its planes to <dir>/planes<i>.npz; a piece that does not
decode to one picture leaves no file.  Imports only the reference
decoder (no torch, nothing of the port)."""

import os
import sys

import numpy as np

from benchmark.reference.vvc.decoder import decode_stream


def main(argv) -> int:
    where, idx = argv[0], argv[1:]
    for i in idx:
        with open(os.path.join(where, f"au{i}.266"), "rb") as f:
            data = f.read()
        try:
            pics = decode_stream(data)
        except Exception as exc:            # noqa: BLE001 - a parse fault
            sys.stderr.write(f"decode_worker: piece {i}: {exc!r}\n")
            continue
        if len(pics) != 1:
            sys.stderr.write(f"decode_worker: piece {i}: {len(pics)} "
                             "pictures where one was sent\n")
            continue
        planes = pics[0].planes             # {plane index: samples}
        np.savez(os.path.join(where, f"planes{i}.npz"),
                 *[np.asarray(planes[c]) for c in sorted(planes)])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
