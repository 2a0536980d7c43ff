"""distsql: send one coprocessor request and collect its partial results
(the port of tidb_tpu/distsql/__init__.py:67 SelectResult, :98-213
columnar, :266 select, cut to the cluster path's columnar payloads).

Reference: distsql/distsql.go:277 Select.
"""

from __future__ import annotations

from tidb_tpu_torch import errors
from tidb_tpu_torch.copr.columnar_region import finish_states_batch
from tidb_tpu_torch.kv import kv
from tidb_tpu_torch.ops import columnar as col
from tidb_tpu_torch.ops.exprc import Unsupported


class SelectResult:
    """The partial results of one request, across all its regions."""

    def __init__(self, resp: kv.Response):
        self._resp = resp

    def columnar(self):
        """Drain every partial and finish the statement: the one region's
        ColumnarAggStates payload, or a ColumnarStatesSet of them in task
        order, with filter and states fulfilled; None when no region
        answered. A region answering rows, or a mix of payload kinds,
        raises Unsupported (the port has no row path yet)."""
        parts = []
        while True:
            part = self._resp.next()
            if part is None:
                break
            if part.error:
                raise errors.TiDBError(f"coprocessor error: {part.error}")
            parts.append(part)
        if not parts:
            return None
        payloads = [p.columnar for p in parts]
        if not all(getattr(p, "is_agg_states", False) for p in payloads):
            raise Unsupported("a response mixing rows and columnar "
                              "payloads comes in a later slice")
        finish_states_batch(payloads)
        if len(payloads) == 1:
            return payloads[0]
        return col.ColumnarStatesSet(payloads)


def select(client: kv.Client, req: kv.Request) -> SelectResult:
    """Send `req` (a kv.Request carrying a SelectRequest) through the
    client and return its SelectResult."""
    return SelectResult(client.send(req))
