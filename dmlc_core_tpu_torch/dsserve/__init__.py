"""dsserve: disaggregated preprocessing over the wire (the port of
``dmlc_core_tpu/dsserve``).

The input pipeline up to the ring-slot boundary — fetch → decode →
gather-parse → pack — runs in standalone CPU worker processes: a
:class:`DsServeServer` runs the port's fused producers and streams
finished packed slots (the ``alloc_packed_slot`` byte layout the staging
pipeline copies to the card) over a length-prefixed binary framing; the
trainer-side ``dsserve://host:port,host:port/...`` source
(:class:`DsServeBatches`) satisfies the staging producer contract, and
its slots are adopted by the staging pipeline without a host copy.
Shard assignment rides the tracker's shard service — the servers are
leaseholders — and the CLIENT commits ``shard_done``, so a server killed
mid-stream costs a lease TTL, never a duplicated or lost row. Imports no
torch.
"""

from .client import DsServeBatches, parse_dsserve_uri
from .server import DsServeServer

__all__ = ["DsServeBatches", "DsServeServer", "parse_dsserve_uri"]
