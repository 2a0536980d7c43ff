"""The table scan executor (the port of
tidb_tpu/executor/distsql_exec.py:121 XSelectTableExec, :172
columnar_result, and next over the columnar payload).

The port has no planner, so the executor is built from what the planner
would have put in the request: the client, the SelectRequest and its key
ranges. Plane-aware parents (HashJoinExec, fused aggregates) call
columnar_result() before any next(): the request then carries
columnar_hint and the client answers with the scan's planes and
selection index (ops.columnar.ColumnarScanResult), so no row is encoded,
decoded or re-extracted. next() serves the same answer as typed rows.
"""

from __future__ import annotations

import dataclasses

from tidb_tpu_torch import distsql
from tidb_tpu_torch.copr.proto import SelectRequest
from tidb_tpu_torch.kv import kv
from tidb_tpu_torch.ops import kernels
from tidb_tpu_torch.ops.exprc import Unsupported


class Executor:
    """Pull-based executor: next() returns a row (a list of Datums) or
    None when done; `schema` has one entry per output column."""

    schema: list = []

    def next(self):
        raise NotImplementedError

    def drain(self) -> list:
        return list(iter(self.next, None))


class XSelectTableExec(Executor):
    """Reference: executor/executor_distsql.go:733."""

    def __init__(self, client: kv.Client, sel: SelectRequest,
                 key_ranges: list):
        if sel.is_agg() or sel.order_by:
            raise Unsupported("the scan executor serves plain scans; "
                              "pushed-down aggregates and TopN through it "
                              "come in a later slice")
        self.client = client
        self.sel = sel
        self.key_ranges = list(key_ranges)
        self.schema = list(sel.table_info.columns)
        self._columnar = None
        self._columnar_tried = False
        self._row_iter = None

    def columnar_result(self):
        """The scan's ColumnarScanResult: one hinted request through the
        client, answered with planes (the port's clients have no row
        answer to a hinted scan; one that answers rows raises)."""
        if self._columnar_tried:
            return self._columnar
        self._columnar_tried = True
        sel = dataclasses.replace(self.sel, columnar_hint=True)
        req = kv.Request(kv.REQ_TYPE_SELECT, sel, self.key_ranges)
        with kernels.phase("scans", getattr(self.client, "device", "cpu")):
            self._columnar = distsql.select(self.client, req).columnar()
        return self._columnar

    def next(self):
        if self._row_iter is None:
            res = self.columnar_result()
            self._row_iter = iter(()) if res is None \
                else res.iter_rows_with_handles()
        nxt = next(self._row_iter, None)
        return None if nxt is None else nxt[1]
