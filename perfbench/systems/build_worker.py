"""One shard's build, in a process of its own: reads a pickled (schema,
inputs) from standard input, writes the pickled ``PackedIndex`` of
``build_from_pretokenized`` to standard output. ``systems/sharded.py``
starts it and is the only writer of its input."""
from __future__ import annotations

import pickle
import sys


def main() -> None:
    from manticoresearch_tpu_torch.index.builder import build_from_pretokenized
    out = sys.stdout.buffer
    sys.stdout = sys.stderr          # the pickle is the only output
    schema, inputs = pickle.load(sys.stdin.buffer)
    packed = build_from_pretokenized(schema, **inputs)
    pickle.dump(packed, out, protocol=pickle.HIGHEST_PROTOCOL)
    out.flush()


if __name__ == "__main__":
    main()
