"""Parquet thrift footer: parse, row-group filter, column prune, re-serialize
(a copy of the JAX package's ``io/parquet_footer.py``: pure Python).

Parity target: ``ParquetFooter.readAndFilter`` (ParquetFooter.java:190-215)
over ``NativeParquetJni.cpp`` — ``deserialize_parquet_footer`` (:639),
``column_pruner`` (:109, Tag tree VALUE/STRUCT/LIST/MAP :102),
``filter_groups`` midpoint-in-split selection (:584), ``filter_columns``
(:671), and the PAR1-wrapped ``serializeThriftFile`` (:793).  Host CPU work in
the reference too (Apache Thrift TCompactProtocol, no GPU), so a host Python
implementation is the idiomatic mapping; the arrays never touch the device.

Instead of transcribing the full parquet.thrift schema, the footer is parsed
into *generic* compact-protocol structs (field-id -> (type, value), in wire
order).  Filtering edits only the fields Spark's split planning needs —
FileMetaData.schema(2) / row_groups(4) / column_orders(7) — and everything
else round-trips byte-for-byte.  Semantic field ids used below (from
parquet-format parquet.thrift):

- FileMetaData: 2=schema, 4=row_groups, 7=column_orders
- SchemaElement: 1=type, 3=repetition_type, 4=name, 5=num_children,
  6=converted_type
- RowGroup: 1=columns, 3=num_rows, 5=file_offset, 6=total_compressed_size
- ColumnChunk: 3=meta_data; ColumnMetaData: 7=total_compressed_size,
  9=data_page_offset, 11=dictionary_page_offset

DELIBERATE DEVIATION from the reference: ``read_and_filter`` rewrites
``FileMetaData.num_rows`` (field 3) to the sum over surviving row groups so
the re-serialized footer is self-consistent; ``NativeParquetJni.cpp`` leaves
the original file-level count stale and computes ``getNumRows`` from
row_groups instead.  Readers that trust FileMetaData.num_rows (parquet-mr
split planning) will see the filtered count here, the unfiltered one there.
"""

from __future__ import annotations

import struct as _structmod
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "ParquetFooter",
    "StructElement",
    "StructBuilder",
    "ValueElement",
    "ListElement",
    "MapElement",
]

# thrift compact-protocol wire types
_T_STOP = 0
_T_TRUE = 1
_T_FALSE = 2
_T_BYTE = 3
_T_I16 = 4
_T_I32 = 5
_T_I64 = 6
_T_DOUBLE = 7
_T_BINARY = 8
_T_LIST = 9
_T_SET = 10
_T_MAP = 11
_T_STRUCT = 12

# parquet enum values used by the pruner
_REPETITION_REPEATED = 2  # FieldRepetitionType.REPEATED
_CONVERTED_MAP = 1  # ConvertedType.MAP
_CONVERTED_MAP_KEY_VALUE = 2  # ConvertedType.MAP_KEY_VALUE

_MAGIC = b"PAR1"


# --------------------------------------------------------------------------
# schema description (mirrors ParquetFooter.java SchemaElement classes)
# --------------------------------------------------------------------------

class SchemaNode:
    """Base of the stripped-down expected-schema tree."""


class ValueElement(SchemaNode):
    pass


class StructElement(SchemaNode):
    def __init__(self, children: Sequence[Tuple[str, SchemaNode]]):
        self.children = list(children)

    @staticmethod
    def builder() -> "StructBuilder":
        return StructBuilder()


class StructBuilder:
    def __init__(self):
        self._children: List[Tuple[str, SchemaNode]] = []

    def add_child(self, name: str, child: SchemaNode) -> "StructBuilder":
        self._children.append((name, child))
        return self

    def build(self) -> StructElement:
        return StructElement(self._children)


class ListElement(SchemaNode):
    def __init__(self, item: SchemaNode):
        self.item = item


class MapElement(SchemaNode):
    def __init__(self, key: SchemaNode, value: SchemaNode):
        self.key = key
        self.value = value


# --------------------------------------------------------------------------
# generic thrift compact protocol
# --------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _unzigzag(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def _zigzag(n: int) -> int:
    return (n << 1) ^ (n >> 63) if n >= 0 else ((-n) << 1) - 1


def _write_varint(out: bytearray, n: int) -> None:
    while True:
        if n & ~0x7F:
            out.append((n & 0x7F) | 0x80)
            n >>= 7
        else:
            out.append(n)
            return


# A parsed struct is a list of (field_id, wire_type, value) in wire order;
# lists are (elem_type, [values]); maps are (ktype, vtype, [(k, v)...]).

TStruct = List[Tuple[int, int, object]]


def _read_value(buf: bytes, pos: int, ttype: int) -> Tuple[object, int]:
    if ttype == _T_TRUE:
        return True, pos
    if ttype == _T_FALSE:
        return False, pos
    if ttype == _T_BYTE:
        return buf[pos], pos + 1
    if ttype in (_T_I16, _T_I32, _T_I64):
        raw, pos = _read_varint(buf, pos)
        return _unzigzag(raw), pos
    if ttype == _T_DOUBLE:
        return _structmod.unpack("<d", buf[pos : pos + 8])[0], pos + 8
    if ttype == _T_BINARY:
        ln, pos = _read_varint(buf, pos)
        return bytes(buf[pos : pos + ln]), pos + ln
    if ttype in (_T_LIST, _T_SET):
        head = buf[pos]
        pos += 1
        etype = head & 0x0F
        size = head >> 4
        if size == 0x0F:
            size, pos = _read_varint(buf, pos)
        vals = []
        for _ in range(size):
            if etype == _T_TRUE:  # bools in lists are one byte each
                vals.append(buf[pos] == 1)
                pos += 1
            else:
                v, pos = _read_value(buf, pos, etype)
                vals.append(v)
        return (etype, vals), pos
    if ttype == _T_MAP:
        size, pos = _read_varint(buf, pos)
        if size == 0:
            return (0, 0, []), pos
        head = buf[pos]
        pos += 1
        ktype, vtype = head >> 4, head & 0x0F
        pairs = []

        def _elem(p, etype):
            # bools in map elements are one byte each, like list elements
            if etype == _T_TRUE:
                return buf[p] == 1, p + 1
            return _read_value(buf, p, etype)

        for _ in range(size):
            k, pos = _elem(pos, ktype)
            v, pos = _elem(pos, vtype)
            pairs.append((k, v))
        return (ktype, vtype, pairs), pos
    if ttype == _T_STRUCT:
        return _read_struct(buf, pos)
    raise ValueError(f"Couldn't deserialize thrift: unknown type {ttype}")


def _read_struct(buf: bytes, pos: int) -> Tuple[TStruct, int]:
    fields: TStruct = []
    last_fid = 0
    while True:
        head = buf[pos]
        pos += 1
        if head == _T_STOP:
            return fields, pos
        delta = head >> 4
        ttype = head & 0x0F
        if delta:
            fid = last_fid + delta
        else:
            raw, pos = _read_varint(buf, pos)
            fid = _unzigzag(raw)
        last_fid = fid
        value, pos = _read_value(buf, pos, ttype)
        fields.append((fid, ttype, value))


def _write_value(out: bytearray, ttype: int, value) -> None:
    if ttype in (_T_TRUE, _T_FALSE):
        return  # encoded in the field header for struct fields
    if ttype == _T_BYTE:
        out.append(value & 0xFF)
    elif ttype in (_T_I16, _T_I32, _T_I64):
        _write_varint(out, _zigzag(value))
    elif ttype == _T_DOUBLE:
        out += _structmod.pack("<d", value)
    elif ttype == _T_BINARY:
        _write_varint(out, len(value))
        out += value
    elif ttype in (_T_LIST, _T_SET):
        etype, vals = value
        if len(vals) < 15:
            out.append((len(vals) << 4) | etype)
        else:
            out.append(0xF0 | etype)
            _write_varint(out, len(vals))
        for v in vals:
            if etype == _T_TRUE:
                out.append(1 if v else 2)
            else:
                _write_value(out, etype, v)
    elif ttype == _T_MAP:
        ktype, vtype, pairs = value
        _write_varint(out, len(pairs))
        if pairs:
            out.append((ktype << 4) | vtype)
            for k, v in pairs:
                if ktype == _T_TRUE:
                    out.append(1 if k else 2)
                else:
                    _write_value(out, ktype, k)
                if vtype == _T_TRUE:
                    out.append(1 if v else 2)
                else:
                    _write_value(out, vtype, v)
    elif ttype == _T_STRUCT:
        _write_struct(out, value)
    else:
        raise ValueError(f"cannot serialize thrift type {ttype}")


def _write_struct(out: bytearray, fields: TStruct) -> None:
    last_fid = 0
    for fid, ttype, value in fields:
        wire_t = ttype
        if ttype in (_T_TRUE, _T_FALSE):
            wire_t = _T_TRUE if value else _T_FALSE
        delta = fid - last_fid
        if 0 < delta <= 15:
            out.append((delta << 4) | wire_t)
        else:
            out.append(wire_t)
            _write_varint(out, _zigzag(fid))
        last_fid = fid
        _write_value(out, ttype, value)
    out.append(_T_STOP)


# --------------------------------------------------------------------------
# field access helpers over generic structs
# --------------------------------------------------------------------------

def _get(fields: TStruct, fid: int, default=None):
    for f, _t, v in fields:
        if f == fid:
            return v
    return default


def _has(fields: TStruct, fid: int) -> bool:
    return any(f == fid for f, _t, _v in fields)


def _set(fields: TStruct, fid: int, ttype: int, value) -> TStruct:
    out = [(f, t, v) for f, t, v in fields if f != fid]
    out.append((fid, ttype, value))
    out.sort(key=lambda x: x[0])  # compact protocol needs ascending ids
    return out


class _Elem:
    """SchemaElement accessor over a generic struct."""

    def __init__(self, fields: TStruct):
        self.fields = fields

    @property
    def name(self) -> str:
        return _get(self.fields, 4, b"").decode("utf-8")

    @property
    def is_leaf(self) -> bool:
        return _has(self.fields, 1)  # type is set

    @property
    def num_children(self) -> int:
        return _get(self.fields, 5, 0) or 0

    @property
    def repetition_type(self) -> Optional[int]:
        return _get(self.fields, 3)

    @property
    def converted_type(self) -> Optional[int]:
        return _get(self.fields, 6)


class _PrunerNode:
    """column_pruner (NativeParquetJni.cpp:109): expected-schema tree node."""

    VALUE, STRUCT, LIST, MAP = range(4)

    def __init__(self, tag: int):
        self.tag = tag
        self.children: Dict[str, "_PrunerNode"] = {}

    @staticmethod
    def from_schema(schema: StructElement, ignore_case: bool) -> "_PrunerNode":
        def build(node: SchemaNode) -> "_PrunerNode":
            if isinstance(node, ValueElement):
                return _PrunerNode(_PrunerNode.VALUE)
            if isinstance(node, StructElement):
                p = _PrunerNode(_PrunerNode.STRUCT)
                for name, child in node.children:
                    p.children[name.lower() if ignore_case else name] = build(child)
                return p
            if isinstance(node, ListElement):
                p = _PrunerNode(_PrunerNode.LIST)
                p.children["element"] = build(node.item)
                return p
            if isinstance(node, MapElement):
                p = _PrunerNode(_PrunerNode.MAP)
                p.children["key"] = build(node.key)
                p.children["value"] = build(node.value)
                return p
            raise TypeError(f"{node} is not a supported schema element type")

        return build(schema)

    # -- filtering (mirrors filter_schema_* at NativeParquetJni.cpp:193-498)

    def filter_schema(self, schema: List[_Elem], ignore_case: bool):
        state = {"si": 0, "ci": 0}
        chunk_map: List[int] = []
        schema_map: List[int] = []
        schema_num_children: List[int] = []
        self._filter(schema, ignore_case, state, chunk_map, schema_map,
                     schema_num_children)
        return schema_map, schema_num_children, chunk_map

    def _name(self, elem: _Elem, ignore_case: bool) -> str:
        return elem.name.lower() if ignore_case else elem.name

    def _skip(self, schema: List[_Elem], state) -> None:
        num_to_skip = 1
        while num_to_skip > 0 and state["si"] < len(schema):
            item = schema[state["si"]]
            if item.is_leaf:
                state["ci"] += 1
            num_to_skip += item.num_children - 1
            state["si"] += 1

    def _filter(self, schema, ignore_case, state, chunk_map, schema_map,
                schema_num_children):
        if self.tag == _PrunerNode.STRUCT:
            self._filter_struct(schema, ignore_case, state, chunk_map,
                                schema_map, schema_num_children)
        elif self.tag == _PrunerNode.VALUE:
            self._filter_value(schema, state, chunk_map, schema_map,
                               schema_num_children)
        elif self.tag == _PrunerNode.LIST:
            self._filter_list(schema, ignore_case, state, chunk_map,
                              schema_map, schema_num_children)
        else:
            self._filter_map(schema, ignore_case, state, chunk_map,
                             schema_map, schema_num_children)

    def _filter_struct(self, schema, ignore_case, state, chunk_map,
                       schema_map, schema_num_children):
        item = schema[state["si"]]
        if item.is_leaf:
            raise ValueError("Found a leaf node, but expected to find a struct")
        num_children = item.num_children
        schema_map.append(state["si"])
        my_nc_index = len(schema_num_children)
        schema_num_children.append(0)
        state["si"] += 1
        for _ in range(num_children):
            if state["si"] >= len(schema):
                break
            child = schema[state["si"]]
            found = self.children.get(self._name(child, ignore_case))
            if found is not None:
                schema_num_children[my_nc_index] += 1
                found._filter(schema, ignore_case, state, chunk_map,
                              schema_map, schema_num_children)
            else:
                self._skip(schema, state)

    def _filter_value(self, schema, state, chunk_map, schema_map,
                      schema_num_children):
        item = schema[state["si"]]
        if not item.is_leaf:
            raise ValueError("found a non-leaf entry when reading a leaf value")
        if item.num_children != 0:
            raise ValueError("found an entry with children when reading a leaf value")
        schema_map.append(state["si"])
        schema_num_children.append(0)
        state["si"] += 1
        chunk_map.append(state["ci"])
        state["ci"] += 1

    def _filter_list(self, schema, ignore_case, state, chunk_map, schema_map,
                     schema_num_children):
        found = self.children["element"]
        item = schema[state["si"]]
        list_name = item.name
        if item.is_leaf:
            # parquet list rule 1: repeated non-group IS the element
            if item.repetition_type != _REPETITION_REPEATED:
                raise ValueError("expected list item to be repeating")
            return self._filter_value(schema, state, chunk_map, schema_map,
                                      schema_num_children)
        if item.num_children > 1:
            # rule 2: repeated group with several fields IS the element
            if item.repetition_type != _REPETITION_REPEATED:
                raise ValueError("expected list item to be repeating")
            return found._filter(schema, ignore_case, state, chunk_map,
                                 schema_map, schema_num_children)
        if item.num_children != 1:
            raise ValueError("the structure of the outer list group is not standard")
        schema_map.append(state["si"])
        schema_num_children.append(1)
        state["si"] += 1

        rep = schema[state["si"]]
        if rep.repetition_type != _REPETITION_REPEATED:
            raise ValueError(
                "the structure of the list's child is not standard (non repeating)")
        if (not rep.is_leaf and rep.num_children == 1
                and rep.name != "array" and rep.name != list_name + "_tuple"):
            # standard 3-level list: keep the middle repeated group too
            schema_map.append(state["si"])
            schema_num_children.append(1)
            state["si"] += 1
            found._filter(schema, ignore_case, state, chunk_map, schema_map,
                          schema_num_children)
        else:
            # legacy 2-level list
            found._filter(schema, ignore_case, state, chunk_map, schema_map,
                          schema_num_children)

    def _filter_map(self, schema, ignore_case, state, chunk_map, schema_map,
                    schema_num_children):
        key_found = self.children["key"]
        value_found = self.children["value"]
        item = schema[state["si"]]
        if item.is_leaf:
            raise ValueError("expected a map item, but found a single value")
        if item.converted_type not in (_CONVERTED_MAP, _CONVERTED_MAP_KEY_VALUE):
            raise ValueError("expected a map type, but it was not found.")
        if item.num_children != 1:
            raise ValueError("the structure of the outer map group is not standard")
        schema_map.append(state["si"])
        schema_num_children.append(1)
        state["si"] += 1

        rep = schema[state["si"]]
        if rep.repetition_type != _REPETITION_REPEATED:
            raise ValueError("found non repeating map child")
        nkids = rep.num_children
        if nkids not in (1, 2):
            raise ValueError("found map with wrong number of children")
        schema_map.append(state["si"])
        schema_num_children.append(nkids)
        state["si"] += 1
        key_found._filter(schema, ignore_case, state, chunk_map, schema_map,
                          schema_num_children)
        if nkids == 2:
            value_found._filter(schema, ignore_case, state, chunk_map,
                                schema_map, schema_num_children)


# --------------------------------------------------------------------------
# row-group split filtering (NativeParquetJni.cpp:554-637)
# --------------------------------------------------------------------------

def _chunk_offset(chunk_fields: TStruct) -> int:
    md = _get(chunk_fields, 3, [])
    offset = _get(md, 9, 0)  # data_page_offset
    dict_off = _get(md, 11)  # dictionary_page_offset
    if dict_off is not None and offset > dict_off:
        offset = dict_off
    return offset


def _invalid_file_offset(start_index, pre_start_index, pre_compressed_size):
    if pre_start_index == 0 and start_index != 4:
        return True
    return start_index < pre_start_index + pre_compressed_size


def _filter_groups(row_groups: List[TStruct], part_offset: int,
                   part_length: int) -> List[int]:
    """Indices of row groups whose byte midpoint lands inside the split
    (filter_groups, NativeParquetJni.cpp:584): every group belongs to
    exactly one split, so byte-range splits partition a file's groups."""
    pre_start_index = 0
    pre_compressed_size = 0
    first_column_with_metadata = True
    if row_groups:
        cols = _get(row_groups[0], 1, (0, []))[1]
        first_column_with_metadata = bool(cols) and _has(cols[0], 3)

    out = []
    for i, rg in enumerate(row_groups):
        cols = _get(rg, 1, (0, []))[1]
        if first_column_with_metadata:
            start_index = _chunk_offset(cols[0])
        else:
            # PARQUET-2078: only the first block's file_offset is reliable
            start_index = _get(rg, 5, 0)
            if _invalid_file_offset(start_index, pre_start_index,
                                    pre_compressed_size):
                start_index = 4 if pre_start_index == 0 else (
                    pre_start_index + pre_compressed_size)
            pre_start_index = start_index
            pre_compressed_size = _get(rg, 6, 0)
        total_size = _get(rg, 6)
        if total_size is None:
            total_size = sum(
                _get(_get(c, 3, []), 7, 0) for c in cols)
        mid_point = start_index + total_size // 2
        if part_offset <= mid_point < part_offset + part_length:
            out.append(i)
    return out


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------

class ParquetFooter:
    """A parsed + filtered parquet footer (FileMetaData).

    ``kept_group_indexes`` records which ORIGINAL row-group indices
    survived the split filter in :meth:`read_and_filter` — the plan an
    external columnar reader needs to seek by group without re-parsing
    the footer (io/parquet_read.py consumes it)."""

    def __init__(self, fields: TStruct,
                 kept_group_indexes: Optional[List[int]] = None):
        self._fields = fields
        self.kept_group_indexes = kept_group_indexes or []

    @staticmethod
    def read_and_filter(buffer: bytes, part_offset: int, part_length: int,
                        schema: StructElement, ignore_case: bool
                        ) -> "ParquetFooter":
        """Parse a raw thrift footer, filter row groups to the split, and
        prune columns to ``schema`` (ParquetFooter.java:190 readAndFilter).

        ``buffer`` holds only the thrift FileMetaData bytes (no PAR1 magic).
        ``part_length < 0`` disables row-group filtering, as in the JNI.
        """
        try:
            meta, _ = _read_struct(bytes(buffer), 0)
        except (IndexError, ValueError) as e:
            raise ValueError(f"Couldn't deserialize thrift: {e}") from e

        pruner = _PrunerNode.from_schema(schema, ignore_case)
        schema_list = _get(meta, 2, (0, []))[1]
        elems = [_Elem(f) for f in schema_list]
        schema_map, schema_num_children, chunk_map = pruner.filter_schema(
            elems, ignore_case)

        new_schema = []
        for orig_index, n_children in zip(schema_map, schema_num_children):
            f = list(schema_list[orig_index])
            if not _Elem(f).is_leaf or _has(f, 5) or n_children != 0:
                f = _set(f, 5, _T_I32, n_children)
            new_schema.append(f)
        meta = _set(meta, 2, _T_LIST, (_T_STRUCT, new_schema))

        orders = _get(meta, 7)
        if orders is not None:
            etype, olist = orders
            new_orders = [olist[i] for i in chunk_map]
            meta = _set(meta, 7, _T_LIST, (etype, new_orders))

        row_groups = _get(meta, 4, (_T_STRUCT, []))[1]
        keep = list(range(len(row_groups)))
        if part_length >= 0:
            keep = _filter_groups(row_groups, part_offset, part_length)
            row_groups = [row_groups[i] for i in keep]
        # prune each group's chunks to the surviving columns
        new_groups = []
        for rg in row_groups:
            etype, cols = _get(rg, 1, (_T_STRUCT, []))
            new_cols = [cols[i] for i in chunk_map]
            new_groups.append(_set(list(rg), 1, _T_LIST, (etype, new_cols)))
        meta = _set(meta, 4, _T_LIST, (_T_STRUCT, new_groups))
        # keep the file-level row count consistent with the surviving groups
        # (the reference leaves FileMetaData.num_rows stale here; fixed
        # deliberately so the serialized footer is self-consistent)
        meta = _set(meta, 3, _T_I64,
                    sum(_get(rg, 3, 0) for rg in new_groups))
        return ParquetFooter(meta, kept_group_indexes=keep)

    @staticmethod
    def split_group_indexes(buffer: bytes, part_offset: int,
                            part_length: int) -> List[int]:
        """Original row-group indices whose midpoint lands in the split —
        the plan a reader uses to materialize ONLY those groups (the
        filter_groups selection of NativeParquetJni.cpp:584, exposed as
        indices so an external columnar reader can seek by group)."""
        meta, _ = _read_struct(bytes(buffer), 0)
        row_groups = _get(meta, 4, (_T_STRUCT, []))[1]
        return _filter_groups(row_groups, part_offset, part_length)

    @property
    def column_names(self) -> List[str]:
        """Top-level column names surviving the prune, in file order
        (what a reader passes as its column projection)."""
        schema = _get(self._fields, 2, (0, []))[1]
        if not schema:
            return []
        out, i = [], 1
        n_top = _Elem(schema[0]).num_children
        while len(out) < n_top and i < len(schema):
            e = _Elem(schema[i])
            out.append(e.name)
            # skip this element's whole subtree to reach the next sibling
            remaining = e.num_children
            i += 1
            while remaining > 0 and i < len(schema):
                remaining += _Elem(schema[i]).num_children - 1
                i += 1
        return out

    @property
    def num_rows(self) -> int:
        """Total rows across surviving row groups (getNumRows, :763)."""
        return sum(_get(rg, 3, 0)
                   for rg in _get(self._fields, 4, (0, []))[1])

    @property
    def num_columns(self) -> int:
        """Top-level column count after pruning (getNumColumns, :778)."""
        schema = _get(self._fields, 2, (0, []))[1]
        if schema:
            return _Elem(schema[0]).num_children
        return 0

    def serialize_thrift_file(self) -> bytes:
        """PAR1 + thrift bytes + u32le length + PAR1 (:793-826) — a footer
        'file' parquet readers accept in place of the original."""
        out = bytearray()
        _write_struct(out, self._fields)
        n = len(out)
        return (_MAGIC + bytes(out)
                + _structmod.pack("<I", n) + _MAGIC)
