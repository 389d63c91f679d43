"""Import a reference LMDB trajectory dataset into the port's trajectory
store (the port's copy of scripts/dataset_converters/lmdb_to_store.py).

The reference ships its VLN-CE / VLN-PE trajectory data as LMDB
environments of msgpack_numpy dicts keyed by path_key
(internnav/dataset/cma_lmdb_dataset.py:41-95). This reads them with the
port's pure-Python LMDB reader and codec (`dataset/lmdb_reader.py`; no
lmdb or msgpack package needed) and writes `dataset/traj_store.TrajStore`,
which `scripts/torch/train.py` reads. A record's "episode_data" dict is
stored when it has one, else the record itself.

    python scripts/torch/lmdb_to_store.py --lmdb data/trajectory_data/train \
        --out data/trajectories.bin [--limit N]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Optional, Sequence

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lmdb", required=True, help="LMDB env dir (or data.mdb)")
    ap.add_argument("--out", required=True, help="output TrajStore path")
    ap.add_argument("--limit", type=int, default=None)
    args = ap.parse_args(argv)

    from internnav_tpu_torch.dataset.lmdb_reader import LmdbTrajectoryReader
    from internnav_tpu_torch.dataset.traj_store import TrajStore

    src = LmdbTrajectoryReader(args.lmdb)
    store = TrajStore(args.out, writable=True)
    n = 0
    for key, record in src.items():
        store.put_tree(key, record.get("episode_data", record))
        n += 1
        if args.limit and n >= args.limit:
            break
    store.close()
    print(f"imported {n} trajectories from {args.lmdb} -> {args.out}")
    return n


if __name__ == "__main__":
    main()
