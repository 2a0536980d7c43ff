"""The port's codec and tablecodec write the JAX package's bytes.

Seeded datums of every kind the coprocessor path carries, row keys and
rows go through both packages' encoders; the output must be byte-equal,
and the port's decoders must read the reference's bytes back.
"""

import datetime as dt
import random
from decimal import Decimal

import pytest

from tidb_tpu import mysqldef as rmy
from tidb_tpu import tablecodec as rtc
from tidb_tpu.codec import codec as rcodec
from tidb_tpu.types import Datum as RDatum
from tidb_tpu.types.datum import NULL as RNULL, Kind as RKind
from tidb_tpu.types.time_types import Duration as RDuration, Time as RTime

from tidb_tpu_torch import carry, tablecodec as ptc
from tidb_tpu_torch.codec import codec as pcodec

SEEDS = [0, 1, 2, 3, 4]


def _ref_datum(rng: random.Random):
    k = rng.randrange(9)
    if k == 0:
        return RNULL
    if k == 1:
        return RDatum.i64(rng.choice([0, 1, -1, (1 << 63) - 1, -(1 << 63),
                                      rng.randrange(-10**12, 10**12)]))
    if k == 2:
        return RDatum.u64(rng.choice([0, (1 << 64) - 1,
                                      rng.randrange(1 << 64)]))
    if k == 3:
        return RDatum.f64(rng.choice([0.0, -0.0, 1.5, -2.25e300, 1e-310,
                                      rng.uniform(-1e6, 1e6)]))
    if k == 4:
        n = rng.choice([0, 1, 7, 8, 9, 16, 40])
        return RDatum.bytes_(bytes(rng.randrange(256) for _ in range(n)))
    if k == 5:
        return RDatum.string("".join(rng.choice("abcé😀 ")
                                     for _ in range(rng.randrange(12))))
    if k == 6:
        digits = rng.randrange(1, 30)
        mant = rng.randrange(10 ** digits) * rng.choice([1, -1])
        return RDatum.dec(Decimal(mant).scaleb(-rng.randrange(0, 12)))
    if k == 7:
        d = dt.datetime(rng.randrange(1000, 9999), rng.randrange(1, 13),
                        rng.randrange(1, 29), rng.randrange(24),
                        rng.randrange(60), rng.randrange(60),
                        rng.randrange(10 ** 6))
        return RDatum(RKind.TIME, RTime(d, rmy.TypeDatetime, 6))
    return RDatum(RKind.DURATION,
                  RDuration(rng.randrange(-10 ** 15, 10 ** 15), 3))


@pytest.mark.parametrize("seed", SEEDS)
def test_encode_value_and_key_bytes_equal(seed):
    rng = random.Random(seed)
    for _ in range(200):
        ref = [_ref_datum(rng) for _ in range(rng.randrange(1, 6))]
        port = [carry.datum_from(d) for d in ref]
        rv = rcodec.encode_value(ref)
        assert pcodec.encode_value(port) == rv
        assert pcodec.encode_key(port) == rcodec.encode_key(ref)
        back = pcodec.decode_all(rv)
        assert pcodec.encode_value(back) == rv


@pytest.mark.parametrize("seed", SEEDS)
def test_row_key_bytes_equal(seed):
    rng = random.Random(seed)
    for _ in range(300):
        tid = rng.choice([1, 45, rng.randrange(1 << 40)])
        h = rng.choice([0, -1, (1 << 63) - 1, -(1 << 63),
                        rng.randrange(-(1 << 63), 1 << 63)])
        key = rtc.encode_row_key(tid, h)
        assert ptc.encode_row_key(tid, h) == key
        assert ptc.decode_row_key(key) == (tid, h)
        assert ptc.table_prefix(tid) == rtc.table_prefix(tid)


@pytest.mark.parametrize("seed", SEEDS)
def test_encode_row_bytes_equal(seed):
    rng = random.Random(seed)
    for _ in range(100):
        n = rng.randrange(0, 12)
        cids = sorted(rng.sample(range(1, 200), n))
        ref = [_ref_datum(rng) for _ in range(n)]
        port = [carry.datum_from(d) for d in ref]
        rv = rtc.encode_row(cids, ref)
        assert ptc.encode_row(cids, port) == rv
        got = ptc.decode_row(rv)
        assert sorted(got) == cids
        assert ptc.encode_row(cids, [got[c] for c in cids]) == rv
