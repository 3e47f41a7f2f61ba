"""Live streams: tail-following RecordIO with watermarks and rotation
(the port of ``dmlc_core_tpu/stream``, with its file names, manifest
bytes, env knobs and metric names, so a writer of either package feeds a
reader of the other).

- ``manifest``: the one commit point between a writer and its readers,
  an atomically replaced ``manifest.json`` naming the sealed shards, the
  live shard's committed (bytes, records) watermark and the end-of-stream
  marker; and every walk over a growing shard's frames.
- ``writer``: ``StreamWriter`` appends records to a live ``.rec`` +
  ``.idx`` shard, commits them durably, rotates into a directory of
  shards and holds back when its readers lag (``DMLC_STREAM_MAX_LAG``).
- ``source``: ``StreamSource``, a split that follows the manifest:
  windowed shuffle inside the watermark, rotation as an epoch boundary,
  leased micro-shards for several workers, a clean end at EOS.

``io.split.create`` follows a stream for ``type="stream"``, ``&stream=1``
or a ``…/manifest.json`` URI. Importing this package loads no torch.
"""

from .manifest import MANIFEST_NAME, read_manifest, write_manifest
from .source import StreamSource
from .writer import StreamWriter

__all__ = [
    "MANIFEST_NAME",
    "StreamSource",
    "StreamWriter",
    "read_manifest",
    "write_manifest",
]
