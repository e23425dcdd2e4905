"""KV-page migration: cached prefix chains serialized into wire frames (the
JAX package's ``frontend/kv_transfer.py`` over the port's torch pools).

  snapshot    ``snapshot_chain`` pulls the longest cached block chain for
              a prompt out of a sender engine's pool: per pool leaf (K,
              V and the int8 pools' scale leaves, layer by layer in the
              tree order of ``resilience.integrity``) one contiguous byte
              string per page, plus a content digest computed with
              exactly the ``kv_block_digest`` algorithm, the digest
              ``kv_checksum`` verifies at acquire, so a migrated page
              carries its integrity identity with it;
  framing     ``split_frames``/``join_frames`` batch pages into bounded
              ``kv_page`` frames (base64 inside JSON). Frames carry
              ``seq``/``n_frames`` so a torn transfer (missing or
              duplicated frame) is rejected as a unit;
  adoption    ``adopt_chain`` inserts received pages into a receiver
              engine's pool BEHIND the prefix-cache publish path: verify
              each page's digest against its transported bytes, stop the
              chain at the first corrupt page (drop + count, never a
              wrong token: the request re-prefills what was dropped),
              copy the accepted prefix into blocks that
              ``reserve_migration_blocks`` hands out, publish via
              ``PrefixCache.release_row`` (first writer wins: duplicate
              chains are freed back), and record the digest via
              ``set_checksum`` so verify-on-acquire guards migrated pages
              exactly like locally published ones.

A transfer has the JAX package's form: ``v``, ``block_size``, ``tokens``,
``layout`` (one ``{"dtype", "shape"}`` per leaf, dtypes by numpy's names,
``"bfloat16"`` as ml_dtypes spells it) and ``pages`` (``digest`` and the
base64 ``leaves``). A bf16 page has no numpy dtype: its bytes travel
through the same-width integer view ``kv_block_digest`` reads.

Threading contract: ``snapshot_chain`` may run on any thread. It reads
only COMMITTED shared pages, pinned against eviction by an acquire-side
refcount. The port's pools are written in place, but a published block
is never written again, and every kernel, copy and read of the serving
path is issued on PyTorch's current stream of the device, the one
default stream every thread shares: the device-to-host copy of a
snapshot is queued behind the windows that wrote those pages.
``adopt_chain`` WRITES pool blocks and must run on the engine's loop
thread (``EngineLoop.run_on_loop``), where the allocator and the prefix
cache are owned; its host-to-device copy lands in freshly reserved
blocks, in stream order before any window that reads them.

One transfer each way: a snapshot gathers the chain's pages of every
leaf on the device and copies them to the host in one copy, and an
adoption copies every accepted page to the device in one copy and
scatters them there. Each copy waits for the shared stream to drain (the
other replicas' windows included) and for the interpreter lock after, so
a copy per page and leaf would pay that wait hundreds of times.

Bit-identity story: every admission commits pool bytes through the
prefill lanes as a pure function of the token's prompt prefix, so a page
computed on the prefill tier is byte-identical to the page the decode
tier would have computed itself, and greedy outputs are unchanged by
migration.
"""

from __future__ import annotations

import base64
import hashlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from pretraining_llm_tpu_torch.resilience.integrity import _DTYPE_NAMES, _leaves

# Per-frame payload budget for page data (pre-base64 bytes), the JAX
# package's; a single page larger than the budget still travels (one page
# per frame).
KV_FRAME_BUDGET_BYTES = 8 * 1024 * 1024

# Transfer payload schema revision (inside the frames).
XFER_VERSION = 1


def _block_axis(leaf: Any) -> int:
    # Mirrors resilience.integrity.kv_block_digest: stacked pools are
    # (L, n_blocks, block_size, ...), per-layer leaves (n_blocks, ...).
    return 1 if leaf.ndim >= 5 else 0


# numpy dtypes of the transported bytes, by the layout's dtype name: a
# bf16 page travels as its int16 view (numpy has no bfloat16).
_WIRE_DTYPES = {
    "float32": np.float32, "float16": np.float16, "bfloat16": np.int16, "int8": np.int8,
}


def _page_digest(names: List[str], arrays: List[np.ndarray]) -> str:
    """Content digest over one page's per-leaf arrays: byte for byte the
    ``resilience.integrity.kv_block_digest`` algorithm (dtype name, then
    raw bytes, per leaf in tree order), taken host-side so one copy off
    the device serves both serialization and integrity."""
    h = hashlib.blake2b(digest_size=16)
    for name, arr in zip(names, arrays):
        h.update(name.encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def _page_shape(leaf: torch.Tensor) -> Tuple[int, ...]:
    """The shape of one block of ``leaf`` (stacked leaves keep their layer
    axis)."""
    return (leaf.shape[0],) + tuple(leaf.shape[2:]) if _block_axis(leaf) == 1 else tuple(leaf.shape[1:])


def _gather_host(leaves: List[torch.Tensor], blocks: List[int]) -> List[List[np.ndarray]]:
    """``[page][leaf]`` host arrays of ``blocks`` in every leaf (bf16 as its
    int16 view), through one device-to-host copy."""
    index = torch.tensor(blocks, dtype=torch.long, device=leaves[0].device)
    flat = []
    for leaf in leaves:
        axis = _block_axis(leaf)
        pages = leaf.detach().index_select(axis, index)
        if axis == 1:
            pages = pages.transpose(0, 1)
        flat.append(pages.contiguous().view(-1).view(torch.uint8))
    host = torch.cat(flat).cpu().numpy()
    out: List[List[np.ndarray]] = [[] for _ in blocks]
    offset = 0
    for leaf in leaves:
        dtype = np.dtype(_WIRE_DTYPES[_DTYPE_NAMES[leaf.dtype]])
        shape = _page_shape(leaf)
        n = len(blocks) * int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        arr = host[offset:offset + n].view(dtype).reshape((len(blocks),) + shape)
        offset += n
        for j in range(len(blocks)):
            out[j].append(arr[j])
    return out


def snapshot_chain(
    engine: Any,
    prompt: List[int],
    *,
    max_pages: Optional[int] = None,
) -> Optional[Dict[str, Any]]:
    """Serialize the longest cached block chain covering ``prompt`` from
    ``engine``'s pool. Returns a transfer dict (see module docstring) or
    None when the engine has no prefix cache or no cached coverage.

    Safe from any thread: the chain's blocks are refcount-pinned via
    ``PrefixCache.acquire`` for the duration of the pull and released
    before returning, and only committed (published/shared) pages are
    ever read."""
    cache = getattr(engine, "prefix_cache", None)
    if cache is None:
        return None
    cached_tokens, acquired = cache.acquire(prompt)
    if not acquired:
        return None
    try:
        blocks = acquired if max_pages is None else acquired[:max_pages]
        leaves = list(_leaves(engine.pools))
        names = [_DTYPE_NAMES[leaf.dtype] for leaf in leaves]
        bs = int(engine.block_size)
        layout: List[Dict[str, Any]] = []
        pages: List[Dict[str, Any]] = []
        for b, arrays in zip(blocks, _gather_host(leaves, list(blocks))):
            digest = _page_digest(names, arrays)
            expected = cache.checksum_of(b)
            if expected is not None and digest != expected:
                # The source page itself is corrupt: ship only the clean
                # prefix; the engine's own verify-on-acquire will deal
                # with the bad block on its next local hit.
                break
            if not layout:
                layout = [
                    {"dtype": name, "shape": list(a.shape)}
                    for name, a in zip(names, arrays)
                ]
            pages.append({
                "digest": digest,
                "leaves": [
                    base64.b64encode(a.tobytes()).decode("ascii")
                    for a in arrays
                ],
            })
    finally:
        cache.release_shared(acquired)
    if not pages:
        return None
    return {
        "v": XFER_VERSION,
        "block_size": bs,
        "tokens": [int(t) for t in prompt[: len(pages) * bs]],
        "layout": layout,
        "pages": pages,
    }


def transfer_bytes(xfer: Dict[str, Any]) -> int:
    """Decoded page-payload bytes of a transfer (the migrated-bytes
    accounting the fleet counters report)."""
    total = 0
    for page in xfer.get("pages", ()):
        for data in page["leaves"]:
            total += (len(data) * 3) // 4  # base64 -> raw, ignoring pad
    return total


def split_frames(
    xfer: Dict[str, Any], *, budget: int = KV_FRAME_BUDGET_BYTES
) -> List[Dict[str, Any]]:
    """Batch a transfer's pages into bounded frames. Frame 0 carries the
    header (tokens, layout, block size); every frame carries
    ``seq``/``n_frames`` so the receiver can detect a torn transfer.
    The caller adds routing fields (op, transfer id, fence stamp)."""
    if budget < 1:
        raise ValueError(f"frame budget must be >= 1, got {budget}")
    groups: List[List[Dict[str, Any]]] = []
    cur: List[Dict[str, Any]] = []
    cur_bytes = 0
    for page in xfer["pages"]:
        pb = sum((len(d) * 3) // 4 for d in page["leaves"])
        if cur and cur_bytes + pb > budget:
            groups.append(cur)
            cur, cur_bytes = [], 0
        cur.append(page)
        cur_bytes += pb
    groups.append(cur)  # header frame exists even for an empty transfer
    frames: List[Dict[str, Any]] = []
    for i, pgs in enumerate(groups):
        frame: Dict[str, Any] = {
            "seq": i, "n_frames": len(groups), "pages": pgs,
        }
        if i == 0:
            frame["v"] = xfer["v"]
            frame["block_size"] = xfer["block_size"]
            frame["tokens"] = xfer["tokens"]
            frame["layout"] = xfer["layout"]
        frames.append(frame)
    return frames


def join_frames(frames: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Reassemble a transfer from its frames (any arrival order).
    Raises ``ValueError`` on a torn transfer: missing/duplicate seq,
    inconsistent ``n_frames``, or a missing header."""
    if not frames:
        raise ValueError("torn kv transfer: no frames")
    n = frames[0].get("n_frames")
    by_seq: Dict[int, Dict[str, Any]] = {}
    for f in frames:
        if f.get("n_frames") != n:
            raise ValueError(
                f"torn kv transfer: inconsistent n_frames "
                f"({f.get('n_frames')} vs {n})"
            )
        seq = f.get("seq")
        if not isinstance(seq, int) or seq < 0 or seq >= n:
            raise ValueError(f"torn kv transfer: bad seq {seq!r} of {n}")
        if seq in by_seq:
            raise ValueError(f"torn kv transfer: duplicate seq {seq}")
        by_seq[seq] = f
    if len(by_seq) != n:
        missing = sorted(set(range(n)) - set(by_seq))
        raise ValueError(f"torn kv transfer: missing frames {missing}")
    head = by_seq[0]
    for key in ("v", "block_size", "tokens", "layout"):
        if key not in head:
            raise ValueError(f"torn kv transfer: header missing {key!r}")
    pages: List[Dict[str, Any]] = []
    for i in range(n):
        pages.extend(by_seq[i]["pages"])
    return {
        "v": head["v"],
        "block_size": head["block_size"],
        "tokens": head["tokens"],
        "layout": head["layout"],
        "pages": pages,
    }


def corrupt_first_page(xfer: Dict[str, Any]) -> bool:
    """Fault-injection hook (``corrupt_kv_migration``): flip one byte in
    the first page's first leaf, leaving the transported digest claiming
    the ORIGINAL bytes — the receiver must detect the mismatch and drop
    the page. Returns False when the transfer has no pages to corrupt."""
    pages = xfer.get("pages") or []
    if not pages:
        return False
    raw = bytearray(base64.b64decode(pages[0]["leaves"][0]))
    if not raw:
        return False
    raw[0] ^= 0xFF
    pages[0]["leaves"][0] = base64.b64encode(bytes(raw)).decode("ascii")
    return True


def adopt_chain(engine: Any, xfer: Dict[str, Any]) -> Dict[str, Any]:
    """Insert a received transfer's pages into ``engine``'s pool behind
    the prefix-cache publish path. MUST run on the engine's loop thread
    (``EngineLoop.run_on_loop``): it takes blocks from the allocator and
    writes them.

    Every page's digest is verified against its TRANSPORTED bytes before
    anything touches the pool; the chain is adopted up to the first
    corrupt page and the remainder dropped (the re-prefill fallback:
    requests simply miss the cache for what was dropped, so corruption
    can cost latency but never a wrong token). Returns
    ``{"inserted", "rejected", "published", "reason"}``."""
    n_pages = len(xfer.get("pages") or [])

    def _bump(adopted: int, dropped: int) -> None:
        stats = getattr(engine, "stats", None)
        if isinstance(stats, dict):
            stats["kv_pages_adopted"] = (
                stats.get("kv_pages_adopted", 0) + adopted
            )
            stats["kv_pages_rejected"] = (
                stats.get("kv_pages_rejected", 0) + dropped
            )

    def _reject_all(reason: str) -> Dict[str, Any]:
        _bump(0, n_pages)
        return {
            "inserted": 0, "rejected": n_pages,
            "published": 0, "reason": reason,
        }

    cache = getattr(engine, "prefix_cache", None)
    if cache is None:
        return _reject_all("no_prefix_cache")
    if n_pages == 0:
        return _reject_all("empty")
    if int(xfer.get("v", -1)) != XFER_VERSION:
        return _reject_all("version_mismatch")
    bs = int(engine.block_size)
    if int(xfer["block_size"]) != bs:
        return _reject_all("block_size_mismatch")
    tokens = [int(t) for t in xfer["tokens"]]
    if len(tokens) < n_pages * bs:
        return _reject_all("short_tokens")
    leaves = list(_leaves(engine.pools))
    layout = xfer["layout"]
    if len(layout) != len(leaves):
        return _reject_all("layout_mismatch")
    for spec, leaf in zip(layout, leaves):
        if (
            tuple(spec["shape"]) != _page_shape(leaf)
            or str(spec["dtype"]) != _DTYPE_NAMES.get(leaf.dtype)
        ):
            return _reject_all("layout_mismatch")

    # Decode + verify host-side BEFORE touching the pool: a corrupt page
    # truncates the adoptable chain (pages after it would be unreachable
    # index entries — their digests chain through the dropped block).
    names = [str(spec["dtype"]) for spec in layout]
    decoded: List[List[np.ndarray]] = []
    rejected_reason = ""
    for page in xfer["pages"]:
        if len(page["leaves"]) != len(layout):
            rejected_reason = "layout_mismatch"
            break
        arrays: List[np.ndarray] = []
        ok = True
        for spec, data in zip(layout, page["leaves"]):
            dtype = np.dtype(_WIRE_DTYPES[str(spec["dtype"])])
            raw = base64.b64decode(data)
            count = int(np.prod(spec["shape"], dtype=np.int64))
            if len(raw) != count * dtype.itemsize:
                ok = False
                break
            arrays.append(
                np.frombuffer(raw, dtype=dtype).reshape(spec["shape"])
            )
        if not ok or _page_digest(names, arrays) != page["digest"]:
            rejected_reason = rejected_reason or "checksum_mismatch"
            break
        decoded.append(arrays)
    k = len(decoded)
    if k == 0:
        return _reject_all(rejected_reason or "checksum_mismatch")

    blocks = engine.reserve_migration_blocks(k)
    if blocks is None:
        _bump(0, n_pages)
        return {
            "inserted": 0, "rejected": n_pages,
            "published": 0, "reason": "capacity",
        }
    # Copy the accepted pages into the reserved blocks in place: every page
    # of every leaf in one host-to-device copy, then scattered by block
    # index on the device (the write that pins adopt_chain to the loop
    # thread).
    host = np.concatenate([
        np.stack([decoded[i][j] for i in range(k)]).reshape(-1).view(np.uint8)
        for j in range(len(leaves))
    ])
    dev = torch.from_numpy(host).to(leaves[0].device)
    index = torch.tensor(blocks, dtype=torch.long, device=leaves[0].device)
    offset = 0
    with torch.no_grad():
        for leaf in leaves:
            shape = (k,) + _page_shape(leaf)
            n = int(np.prod(shape, dtype=np.int64)) * leaf.element_size()
            pages = dev[offset:offset + n].view(leaf.dtype).view(shape)
            offset += n
            if _block_axis(leaf) == 1:
                leaf.index_copy_(1, index, pages.transpose(0, 1))
            else:
                leaf.index_copy_(0, index, pages)

    # Publish behind the normal path: n_shared=0, publish_len = the full
    # adopted span, so release_row indexes every block (duplicates of
    # chains this engine already holds go straight back to the
    # allocator — first writer wins) and returns the newly published
    # ids, which get the transported digest as their acquire-side
    # checksum exactly like a locally computed publish would.
    published = cache.release_row(tokens[: k * bs], blocks, 0, k * bs)
    digest_by_block = {
        b: page["digest"] for b, page in zip(blocks, xfer["pages"])
    }
    for b in published:
        cache.set_checksum(b, digest_by_block[b])
    _bump(k, n_pages - k)
    return {
        "inserted": k,
        "rejected": n_pages - k,
        "published": len(published),
        "reason": rejected_reason,
    }
