"""OCDBT key-value stores, tensorstore's "OCDBT storage format", the layout
orbax keeps a checkpoint's arrays in, read and written without tensorstore.

A database is a directory.  `manifest.ocdbt` holds the configuration, a
data-file table and the list of versions (one per commit, the newest last);
each version names the root of a B+tree.  Tree nodes and large values live
in data files (`d/<hex>`, or `ocdbt.process_<i>/d/<hex>` in a checkpoint
that orbax merged from its processes' databases), at an offset and length
that the referring entry gives.  Every path in a data-file table is
relative to the database directory, so the root manifest alone reaches
every key of a merged checkpoint, and the per-process manifests are not
read.

Encoding, as worked out from databases written by tensorstore 0.1.80:
- Manifest and node files: a header (magic, uint32 big-endian: 0x0cdb3a2a
  for a manifest, 0x0cdb20de for a node; the file's length, uint64
  little-endian; a version varint, 0; a compression varint, 0 none or 1
  zstd), the body, compressed as the header says, and a CRC-32C of all the
  bytes before it (uint32 little-endian).
- Varints are unsigned LEB128.  Arrays of fields are stored field by field
  ("all lengths, then all data file ids, ..."), not entry by entry.
- Manifest body: the config (uuid 16 bytes; manifest kind, max inline value
  bytes, max decoded node bytes as varints; version tree arity log2, one
  byte; compression method varint, with an int32 zstd level when it is 1),
  a data-file table, the inline versions (generation, root height, data
  file id, offset, length, keys, tree bytes, indirect value bytes,
  commit time as uint64) and references to version tree nodes, which hold
  older versions only.
- Data-file table: count; prefix lengths shared with the previous path;
  suffix lengths; base-path lengths; the suffixes.
- Node body: height (one byte; 0 is a leaf), the node's own data-file
  table, the entry count, the keys (prefix lengths shared with the previous
  key, suffix lengths, then the suffixes).  A leaf then gives value lengths,
  value kinds (0 inline, 1 in a data file), the data file ids and offsets of
  the indirect values and the inline values concatenated.  An interior node
  gives, per child, the length of the key prefix common to its subtree
  (which the child's keys leave out), then data file ids, offsets, lengths,
  key counts, tree bytes and indirect value bytes.
- The byte totals count what a subtree holds: its encoded node files
  (tree bytes) and the values of its leaves that lie in data files
  (indirect value bytes); a version gives them for the whole tree.

`write_ocdbt` writes a database of one version (generation 1) in that
format, uncompressed: every value longer than the inline limit, then the
tree nodes bottom-up, in one data file `d/<32 hex digits>`.
"""

from __future__ import annotations

import os
import struct
import time

from relativepose_tpu_torch.native import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_EMPTY = (1 << 64) - 1   # offset and length of an empty tree's root


class _Body:
    """A cursor over a decoded manifest or node body."""

    def __init__(self, data: bytes, name: str):
        self.data, self.pos, self.name = data, 0, name

    def error(self, what: str) -> ValueError:
        return ValueError(f"OCDBT {self.name}: {what}")

    def raw(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            raise self.error("truncated")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.raw(1)[0]

    def varint(self) -> int:
        value = shift = 0
        while True:
            b = self.byte()
            value |= (b & 0x7F) << shift
            if b < 0x80:
                break
            shift += 7
            if shift > 63:
                raise self.error("varint longer than 64 bits")
        if value >> 64:
            raise self.error("varint longer than 64 bits")
        return value

    def varints(self, n: int) -> list:
        return [self.varint() for _ in range(n)]

    def prefixed(self, n: int, extra: bool = False):
        """`n` prefix-compressed byte strings: the lengths each shares with
        the previous one (n-1 varints), the suffix lengths, with `extra` one
        more array of n varints (returned beside the strings), then the
        suffixes."""
        shared = self.varints(max(n - 1, 0))
        suffix = self.varints(n)
        more = self.varints(n) if extra else None
        out, prev = [], b""
        for i in range(n):
            keep = shared[i - 1] if i else 0
            if keep > len(prev):
                raise self.error("prefix longer than the previous key")
            prev = prev[:keep] + self.raw(suffix[i])
            out.append(prev)
        return (out, more) if extra else out

    def end(self):
        if self.pos != len(self.data):
            raise self.error(f"{len(self.data) - self.pos} bytes left over")


def _unframe(blob: bytes, magic: int, name: str) -> bytes:
    """A manifest or node file's body, its header and CRC-32C checked."""
    if len(blob) < 18:
        raise ValueError(f"OCDBT {name}: truncated ({len(blob)} bytes)")
    got_magic, length = struct.unpack(">I", blob[:4])[0], \
        struct.unpack("<Q", blob[4:12])[0]
    if got_magic != magic:
        raise ValueError(f"OCDBT {name}: magic {got_magic:#010x}, "
                         f"expected {magic:#010x}")
    if length != len(blob):
        raise ValueError(f"OCDBT {name}: header says {length} bytes, "
                         f"found {len(blob)}")
    crc = struct.unpack("<I", blob[-4:])[0]
    if zstd.crc32c(memoryview(blob)[:-4]) != crc:
        raise ValueError(f"OCDBT {name}: CRC-32C mismatch")
    head = _Body(blob[12:-4], name)
    version, compression = head.varint(), head.varint()
    if version != 0:
        raise NotImplementedError(f"OCDBT {name}: format version {version}")
    body = head.data[head.pos:]
    if compression == 1:
        return zstd.decompress(body).tobytes()
    if compression != 0:
        raise NotImplementedError(f"OCDBT {name}: compression {compression}")
    return body


class OcdbtReader:
    """The newest version of the OCDBT database in directory `path`.

    `keys()` lists the keys (str, sorted); `read(key)` returns a value's
    bytes and raises KeyError for a key that is not there.  The tree is
    walked once, on opening; values are read from their files on demand.
    """

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        body = _Body(_unframe(self._file("manifest.ocdbt"), MANIFEST_MAGIC,
                              "manifest.ocdbt"), "manifest.ocdbt")
        body.raw(16)                           # uuid
        kind = body.varint()
        if kind != 0:
            raise NotImplementedError(
                "OCDBT: numbered manifests (manifest_kind "
                f"{kind}) are not read; orbax writes a single manifest")
        body.varints(2)                        # max inline value / node bytes
        body.byte()                            # version tree arity log2
        if body.varint() == 1:                 # zstd, then its level
            body.raw(4)
        files = self._data_files(body)
        n = body.varint()
        gens = body.varints(n)
        heights = [body.byte() for _ in range(n)]
        fids, offsets, lengths = (body.varints(n) for _ in range(3))
        body.varints(3 * n)                    # keys, tree and value bytes
        body.raw(8 * n)                        # commit times
        if not n:
            raise ValueError("OCDBT manifest.ocdbt: no version")
        i = max(range(n), key=gens.__getitem__)
        self.height = heights[i]   # of the root node; 0 is a leaf
        self._values = {}
        if offsets[i] != _EMPTY:
            self._walk(self._ref(files, fids[i], "manifest.ocdbt"),
                       offsets[i], lengths[i], heights[i], b"")

    def _file(self, rel: str, offset: int = 0, length: int = None) -> bytes:
        with open(os.path.join(self.path, rel), "rb") as f:
            f.seek(offset)
            out = f.read(-1 if length is None else length)
        if length is not None and len(out) != length:
            raise ValueError(f"OCDBT {rel}: {length} bytes at {offset} "
                             f"reach past the end of the file")
        return out

    @staticmethod
    def _data_files(body: _Body) -> list:
        paths = []
        for p in body.prefixed(body.varint(), extra=True)[0]:
            rel = p.decode()
            parts = rel.split("/")
            if rel and (rel.startswith("/") or ".." in parts):
                raise ValueError(f"OCDBT {body.name}: data file {rel!r} "
                                 "lies outside the database")
            paths.append(rel)
        return paths

    @staticmethod
    def _ref(files: list, fid: int, name: str) -> str:
        if fid >= len(files):
            raise ValueError(f"OCDBT {name}: data file id {fid} of "
                             f"{len(files)}")
        return files[fid]

    def _walk(self, rel: str, offset: int, length: int, height: int,
              prefix: bytes):
        name = f"{rel}@{offset}"
        node = _Body(_unframe(self._file(rel, offset, length), NODE_MAGIC,
                              name), name)
        if node.byte() != height:
            raise node.error("height differs from its reference")
        files = self._data_files(node)
        n = node.varint()
        if height:
            keys, prefix_lengths = node.prefixed(n, extra=True)
            fids, offsets, lengths = (node.varints(n) for _ in range(3))
            node.varints(3 * n)                # keys, tree and value bytes
            node.end()
            for i in range(n):
                if prefix_lengths[i] > len(keys[i]):
                    raise node.error("subtree prefix longer than its key")
                self._walk(self._ref(files, fids[i], name), offsets[i],
                           lengths[i], height - 1,
                           prefix + keys[i][:prefix_lengths[i]])
            return
        keys = node.prefixed(n)
        sizes = node.varints(n)
        kinds = node.varints(n)
        if any(k > 1 for k in kinds):
            raise node.error(f"value kind {max(kinds)}")
        n_ind = sum(kinds)
        ind_fids, ind_offsets = node.varints(n_ind), node.varints(n_ind)
        j = 0
        for key, size, kind in zip(keys, sizes, kinds):
            if kind:
                ref = (self._ref(files, ind_fids[j], name), ind_offsets[j],
                       size)
                j += 1
            else:
                ref = node.raw(size)
            self._values[prefix + key] = ref
        node.end()

    def keys(self) -> list:
        return sorted(k.decode() for k in self._values)

    def __contains__(self, key) -> bool:
        return (key.encode() if isinstance(key, str) else key) in self._values

    def read(self, key) -> bytes:
        ref = self._values[key.encode() if isinstance(key, str) else key]
        return ref if isinstance(ref, bytes) else self._file(*ref)


# ------------------------------------------------------------------ writing

# orbax's configuration (tensorstore_utils.add_ocdbt_write_options)
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4
# bounds, in bytes, of a node's height, data file table and entry count,
# and of what a leaf entry or an interior entry adds besides its key
_NODE_BOUND, _LEAF_ENTRY_BOUND, _CHILD_ENTRY_BOUND = 64, 40, 80


def _varint(n: int) -> bytes:
    out = bytearray()
    while n >= 0x80:
        out.append(n & 0x7F | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _varints(ns) -> bytes:
    return b"".join(map(_varint, ns))


def _common(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def _prefixed(strings: list, extra: list = None) -> bytes:
    """The inverse of `_Body.prefixed`."""
    shared = [_common(a, b) for a, b in zip(strings, strings[1:])]
    suffixes = [s[k:] for s, k in zip(strings, [0] + shared)]
    return (_varints(shared) + _varints(map(len, suffixes))
            + (_varints(extra) if extra is not None else b"")
            + b"".join(suffixes))


def _data_file_table(paths: list) -> bytes:
    return _varint(len(paths)) + _prefixed([p.encode() for p in paths],
                                           [0] * len(paths))


def _frame(magic: int, body: bytes) -> bytes:
    """Header (uncompressed, format version 0), body and CRC-32C."""
    head = struct.pack(">I", magic) + struct.pack("<Q", len(body) + 18) \
        + b"\x00\x00"
    blob = head + body
    return blob + struct.pack("<I", zstd.crc32c(blob))


class _Node:
    """A subtree while the tree is built: its children (None for a leaf),
    its keys' range and what it holds."""

    def __init__(self, items: list, children: list = None):
        self.items, self.children = items, children
        self.first = items[0][0]
        self.last = children[-1].last if children else items[-1][0]
        self.keys = sum(it[2] for it in items) if children else len(items)
        self.ref = None   # (offset, length) once written
        self.tree_bytes = self.value_bytes = 0


def _pack(items: list, size, limit: int) -> list:
    """Consecutive groups of `items`, each within `limit` bytes by
    `size(item)` (a bound: the keys' prefixes are not taken off)."""
    groups, cur, used = [], [], _NODE_BOUND
    for it in items:
        n = size(it)
        if cur and used + n > limit:
            groups.append(cur)
            cur, used = [], _NODE_BOUND
        cur.append(it)
        used += n
    return groups + [cur] if cur else groups


def write_ocdbt(path: str, values: dict,
                max_decoded_node_bytes: int = MAX_DECODED_NODE_BYTES) -> str:
    """Write the OCDBT database of `values` ({key: bytes-like}, str or
    bytes keys) into the new directory `path`; returns its data file's
    path relative to `path`.

    The root is one leaf while its encoded body fits in
    `max_decoded_node_bytes` (orbax asks for 100 MB); past that, leaves go
    under interior nodes, each child's keys without its subtree's common
    prefix, as `OcdbtReader` reads them."""
    items = sorted(((k.encode() if isinstance(k, str) else bytes(k),
                     memoryview(v).cast("B")) for k, v in values.items()),
                   key=lambda kv: kv[0])
    if any(a[0] == b[0] for a, b in zip(items, items[1:])):
        raise ValueError("OCDBT: duplicate keys")
    os.makedirs(os.path.join(path, "d"))
    rel = "d/" + os.urandom(16).hex()
    with open(os.path.join(path, rel), "wb") as f:
        # the values stored out of line first, then the nodes bottom-up
        leaf_items = []
        for key, v in items:
            if len(v) > MAX_INLINE_VALUE_BYTES:
                leaf_items.append((key, v, f.tell()))
                f.write(v)
            else:
                leaf_items.append((key, v, None))
        level = [_Node(g) for g in _pack(
            leaf_items, lambda it: len(it[0]) + _LEAF_ENTRY_BOUND + (
                len(it[1]) if it[2] is None else 0),
            max_decoded_node_bytes)]
        height = 0
        while len(level) > 1:
            level = [_Node(g, [it[1] for it in g])
                     for g in _pack([(n.first, n, n.keys) for n in level],
                                    lambda it: len(it[0])
                                    + _CHILD_ENTRY_BOUND,
                                    max_decoded_node_bytes)]
            height += 1
        root = level[0] if level else None
        if root is not None:
            _write_node(f, rel, root, b"", height)
    config = (os.urandom(16) + _varints([0, MAX_INLINE_VALUE_BYTES,
                                         max_decoded_node_bytes])
              + bytes([VERSION_TREE_ARITY_LOG2]) + _varint(0))
    if root is None:    # an empty tree: no data file to name
        table, ref, counts = _data_file_table([""]), (_EMPTY, _EMPTY), \
            (0, 0, 0)
    else:
        table, ref = _data_file_table([rel]), root.ref
        counts = (root.keys, root.tree_bytes, root.value_bytes)
    body = (config + table + _varint(1) + _varint(1) + bytes([height])
            + _varints([0, *ref, *counts])
            + struct.pack("<Q", time.time_ns()) + _varint(0))
    with open(os.path.join(path, "manifest.ocdbt"), "wb") as f:
        f.write(_frame(MANIFEST_MAGIC, body))
    return rel


def _write_node(f, rel: str, node: _Node, prefix: bytes, height: int):
    """Write `node` (its children first) at the end of data file `f`
    (`rel` in the database), its keys without `prefix`; sets its ref and
    byte totals."""
    n = len(node.items)
    if node.children is None:
        keys = [k[len(prefix):] for k, _, _ in node.items]
        ind = [off for _, _, off in node.items if off is not None]
        node.value_bytes = sum(len(v) for _, v, off in node.items
                               if off is not None)
        body = (bytes([0]) + _data_file_table([rel] if ind else [])
                + _varint(n) + _prefixed(keys)
                + _varints(len(v) for _, v, _ in node.items)
                + _varints(int(off is not None) for _, _, off in node.items)
                + _varints([0] * len(ind)) + _varints(ind)
                + b"".join(v for _, v, off in node.items if off is None))
    else:
        subs = []
        for child in node.children:
            sub = child.first[:_common(child.first, child.last)]
            _write_node(f, rel, child, sub, height - 1)
            subs.append(sub)
        node.tree_bytes = sum(c.tree_bytes for c in node.children)
        node.value_bytes = sum(c.value_bytes for c in node.children)
        cs = node.children
        body = (bytes([height]) + _data_file_table([rel]) + _varint(n)
                + _prefixed([c.first[len(prefix):] for c in cs],
                            [len(s) - len(prefix) for s in subs])
                + _varints([0] * n) + _varints(c.ref[0] for c in cs)
                + _varints(c.ref[1] for c in cs)
                + _varints(c.keys for c in cs)
                + _varints(c.tree_bytes for c in cs)
                + _varints(c.value_bytes for c in cs))
    blob = _frame(NODE_MAGIC, body)
    node.ref = (f.tell(), len(blob))
    node.tree_bytes += len(blob)
    f.write(blob)
