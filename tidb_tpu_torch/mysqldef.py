"""MySQL type codes and flags (copy of tidb_tpu/mysqldef, the subset the
port consults)."""

# ---- column type codes (mysql/type.go) ----
TypeDecimal = 0x00
TypeTiny = 0x01
TypeShort = 0x02
TypeLong = 0x03
TypeFloat = 0x04
TypeDouble = 0x05
TypeNull = 0x06
TypeTimestamp = 0x07
TypeLonglong = 0x08
TypeInt24 = 0x09
TypeDate = 0x0A
TypeDuration = 0x0B
TypeDatetime = 0x0C
TypeYear = 0x0D
TypeNewDate = 0x0E
TypeVarchar = 0x0F
TypeBit = 0x10
TypeNewDecimal = 0xF6
TypeEnum = 0xF7
TypeSet = 0xF8
TypeTinyBlob = 0xF9
TypeMediumBlob = 0xFA
TypeLongBlob = 0xFB
TypeBlob = 0xFC
TypeVarString = 0xFD
TypeString = 0xFE
TypeGeometry = 0xFF

STRING_TYPES = frozenset(
    (TypeVarchar, TypeVarString, TypeString, TypeBlob, TypeTinyBlob,
     TypeMediumBlob, TypeLongBlob)
)
INTEGER_TYPES = frozenset((TypeTiny, TypeShort, TypeInt24, TypeLong, TypeLonglong, TypeYear))
FLOAT_TYPES = frozenset((TypeFloat, TypeDouble))
TIME_TYPES = frozenset((TypeDate, TypeNewDate, TypeDatetime, TypeTimestamp))

# ---- column flags (mysql/const.go) ----
NotNullFlag = 1
UnsignedFlag = 32
BinaryFlag = 128


def has_unsigned_flag(flag: int) -> bool:
    return bool(flag & UnsignedFlag)


# ---- error codes (subset of mysql/errcode.go) ----
ErrUnknown = 1105
ErrTruncated = 1265
ErrDataTooLong = 1406
