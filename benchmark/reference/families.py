# Frozen copy of ros_vision_tpu_torch/apriltag/families.py
# at commit 5b978635277ede7c3d2dd15eeb95ccc7be8ca268,
# kept for the benchmark alone, so that the yardstick does not move
# when the port does. Only the imports were changed.
"""AprilTag code families (36h11 / 36h10 / 25h9 / 16h5 + drop-in loading).

The port's own copy of ros_vision_tpu/apriltag/families.py, reading the
port's own copy of ``_families_data.npz`` beside it.

Capability parity with the vendored apriltag library's tag family tables used
by the reference detector (family selected at
apriltags_cuda_detector.cu:137-193, tag36h11; the full official roster incl.
the reversed-border families appears at apriltag_utils.cu:10-33). Shipped
tables are regenerated from OpenCV's official aruco dictionaries and verified
against each family's guaranteed minimum Hamming distance
(see scripts/extract_tag_families.py).

Official reversed-border tables (tagCircle*/tagStandard*/tagCustom*) cannot be
regenerated bit-exactly offline; :func:`load_external_table` makes closing
that gap a pure data drop: point it at the official apriltag3 C source (e.g.
``tagStandard41h12.c``) or a CSV of hex codes, and it parses the layout
(``bit_x``/``bit_y`` — these families place data bits OUTSIDE the border, so
the layout is not a dense grid), derives all four rotation readings
geometrically, verifies the family's minimum Hamming distance, and registers
the family under its official name for use in :class:`DetectorConfig`.

Conventions:
  - A "code" is the MSB-first reading of the family's bit list (bit 0 = MSB),
    bit value 1 = white module. For classic dense families the bit list is
    the row-major data grid (MSB = top-left module).
  - ``codes[:, r]`` is the code observed when the physical tag appears rotated
    by r*90deg counterclockwise in the sampled grid; decoding against all four
    rotations yields the tag's orientation.
  - Bit coordinates follow apriltag3: integer module positions relative to
    the BORDER square's origin, so the border ring occupies the outermost
    modules of ``[0, width_at_border)`` and classic dense data sits at
    ``1..grid_size``. Reversed-border families may use negative coords /
    coords >= width_at_border (bits outside the border ring).
"""
from __future__ import annotations

import dataclasses
import functools
import os
import re

import numpy as np

_DATA_PATH = os.path.join(os.path.dirname(__file__), "_families_data.npz")


@dataclasses.dataclass(frozen=True)
class TagFamily:
    name: str
    grid_size: int            # modules per side of the data grid (6 for 36h11)
    # for non-dense layouts (official reversed-border families) this is 0 and
    # bit_coords supplies the layout
    min_hamming: int          # guaranteed min distance of the family
    codes: np.ndarray         # (n_codes, 4) uint64, all four rotations
    reversed_border: bool = False   # border ring is WHITE inside a black
    # surround (the reference's rcode families, apriltag_utils.cu:10-33:
    # tagCircle*/tagStandard*/tagCustom*); the detected quad's gradient
    # points INTO the tag and the border gray models swap polarity.
    # For classic families the total tag side in modules incl. the 1-module
    # black border ring and the 1-module white quiet zone is grid_size + 2
    # (+2); the detected quad spans the outer edge of the black border:
    # grid_size + 2 modules.
    bit_xy: np.ndarray | None = None   # (nbits, 2) int bit_x/bit_y module
    # coords (apriltag3 convention, relative to the border square); None =
    # classic dense row-major grid
    width_at_border_: int = 0          # 0 -> grid_size + 2 (classic)
    total_width_: int = 0              # 0 -> border_size + 2 (classic: data
    # never extends past the border, +2 margin covers the sharpening halo)

    @property
    def n_codes(self) -> int:
        return int(self.codes.shape[0])

    @property
    def nbits(self) -> int:
        if self.bit_xy is not None:
            return int(self.bit_xy.shape[0])
        return self.grid_size * self.grid_size

    @property
    def border_size(self) -> int:
        """Modules per side of the border square (the detected quad spans
        its outer edge) — apriltag3's width_at_border."""
        return self.width_at_border_ or self.grid_size + 2

    @property
    def total_width(self) -> int:
        """Modules per side of the full tag pattern (apriltag3 total_width;
        >= border_size when data bits sit outside the border ring)."""
        return self.total_width_ or self.border_size + 2

    def bit_coords(self) -> np.ndarray:
        """(nbits, 2) int array of (bit_x, bit_y) module coords."""
        if self.bit_xy is not None:
            return self.bit_xy
        g = self.grid_size
        i = np.arange(g * g)
        return np.stack([1 + i % g, 1 + i // g], -1).astype(np.int64)

    def code_grid(self, tag_id: int, rotation: int = 0) -> np.ndarray:
        """(grid_size, grid_size) 0/1 array, 1 = white module (classic
        dense families only)."""
        if self.bit_xy is not None:
            raise ValueError(f"{self.name} has a non-dense bit layout; "
                             "use module_image()")
        v = int(self.codes[tag_id, rotation])
        bits = [(v >> (self.nbits - 1 - i)) & 1 for i in range(self.nbits)]
        return np.array(bits, np.uint8).reshape(self.grid_size, self.grid_size)

    def pattern_geometry(self) -> tuple[int, int]:
        """(side, origin) of module_image: side = pattern extent + 1-module
        quiet ring on each side; origin = index of border-square module
        (0, 0) inside the image. Classic dense: (grid_size + 4, 1)."""
        bc = self.bit_coords()
        lo = min(0, int(bc.min()))
        hi = max(self.border_size, int(bc.max()) + 1)
        return hi - lo + 2, 1 - lo

    def module_image(self, tag_id: int, rotation: int = 0) -> np.ndarray:
        """Canonical per-module tag image incl. a 1-module quiet zone,
        (side, side) uint8 {0, 255} with side from pattern_geometry().
        Paint order: quiet color everywhere, border ring, then each data
        bit at its layout coordinate (bits may overpaint quiet-zone
        modules for families whose data sits outside the border)."""
        wb = self.border_size
        side, off = self.pattern_geometry()
        img = np.full((side, side),
                      0 if self.reversed_border else 255, np.uint8)
        bc = 255 if self.reversed_border else 0
        img[off:off + wb, off:off + wb] = bc            # border square
        inner = 255 - bc
        if wb > 2:
            img[off + 1:off + wb - 1, off + 1:off + wb - 1] = inner
        v = int(self.codes[tag_id, rotation])
        nb = self.nbits
        for i, (bx, by) in enumerate(self.bit_coords()):
            img[by + off, bx + off] = 255 * ((v >> (nb - 1 - i)) & 1)
        return img

    def render(self, tag_id: int, module_px: int = 1) -> np.ndarray:
        """Render the canonical tag image (incl. border + quiet zone),
        uint8 {0, 255}. Classic families: side = (grid_size + 4) *
        module_px (border + 1-module quiet zone around the data grid);
        non-dense layouts size per pattern_geometry()."""
        img = self.module_image(tag_id)
        if module_px != 1:
            img = np.kron(img, np.ones((module_px, module_px), np.uint8))
        return img


#: families registered at runtime (load_external_table / register_family)
_EXTERNAL: dict[str, TagFamily] = {}


@functools.lru_cache(maxsize=None)
def _get_builtin(name: str) -> TagFamily:
    data = np.load(_DATA_PATH)
    try:
        codes = data[f"{name}_codes"]
        meta = data[f"{name}_meta"]
    except KeyError as e:
        raise ValueError(f"unknown tag family {name!r}") from e
    ms, h = int(meta[1]), int(meta[2])
    rev = bool(meta[3]) if len(meta) > 3 else False
    return TagFamily(name=name, grid_size=ms, min_hamming=h, codes=codes,
                     reversed_border=rev)


def get_family(name: str = "tag36h11") -> TagFamily:
    if name in _EXTERNAL:
        return _EXTERNAL[name]
    return _get_builtin(name)


def list_families() -> list[str]:
    data = np.load(_DATA_PATH)
    built = {k[: -len("_codes")] for k in data.files if k.endswith("_codes")}
    return sorted(built | set(_EXTERNAL))


def register_family(fam: TagFamily) -> TagFamily:
    """Register a runtime-loaded family under fam.name (get_family serves
    it; replaces any previous registration of the same name)."""
    _EXTERNAL[fam.name] = fam
    return fam


def _rotation_permutation(bit_xy: np.ndarray, wb: int) -> np.ndarray:
    """perm such that rotated_code_bits[i] = code_bits[perm[i]] for one
    90deg CCW apparent rotation of the tag: the module that lands at
    bit i's coordinate came from coordinate rot^-1(coords[i]). Derived
    from the dense-grid convention (codes[:, r] reads np.rot90(grid, r)):
    source(bx', by') = (wb - 1 - by', bx'). The layout must be closed
    under rotation (all apriltag3 layouts are)."""
    coord_to_idx = {(int(x), int(y)): i for i, (x, y) in enumerate(bit_xy)}
    perm = np.empty(len(bit_xy), np.int64)
    for i, (bx, by) in enumerate(bit_xy):
        src = (wb - 1 - int(by), int(bx))
        if src not in coord_to_idx:
            raise ValueError(
                f"bit layout not closed under 90deg rotation: bit {i} at "
                f"({int(bx)}, {int(by)}) has no source module at {src}")
        perm[i] = coord_to_idx[src]
    return perm


def _codes_all_rotations(codes0: np.ndarray, bit_xy: np.ndarray,
                         wb: int) -> np.ndarray:
    """(n,) rotation-0 codes -> (n, 4) all-rotation table via the layout's
    geometric rotation permutation."""
    nbits = len(bit_xy)
    perm = _rotation_permutation(bit_xy, wb)
    shifts = (np.uint64(nbits - 1) - np.arange(nbits, dtype=np.uint64))
    bits = (codes0[:, None] >> shifts[None, :]) & np.uint64(1)  # (n, nbits)
    out = np.zeros((len(codes0), 4), np.uint64)
    cur = bits
    weights = (np.uint64(1) << (np.uint64(nbits - 1)
                                - np.arange(nbits, dtype=np.uint64)))
    for r in range(4):
        out[:, r] = (cur * weights).sum(-1, dtype=np.uint64)
        cur = cur[:, perm]
    return out


def verify_min_hamming(codes: np.ndarray, nbits: int, min_h: int) -> int:
    """Min pairwise Hamming distance over all (id, rotation) readings that
    must be distinguishable: distinct ids at any rotation pair AND the same
    id at distinct rotations (the unique-orientation property). Raises if
    below min_h; returns the measured minimum."""
    flat = codes.reshape(-1).astype(np.uint64)        # (n*4,)
    n = codes.shape[0]
    ids = np.repeat(np.arange(n), 4)
    xor = flat[:, None] ^ flat[None, :]
    ham = np.zeros(xor.shape, np.int64)
    x = xor.copy()
    for _ in range(nbits):
        ham += (x & np.uint64(1)).astype(np.int64)
        x >>= np.uint64(1)
    ham[np.arange(len(flat)), np.arange(len(flat))] = nbits + 1
    same_id = ids[:, None] == ids[None, :]
    got = int(ham.min())
    # same-id different-rotation pairs must also be distinct (any distance
    # >= 1 suffices for orientation disambiguation per apriltag semantics,
    # but official families guarantee min_h there too)
    if got < min_h:
        where = "same-id rotations" if bool(
            same_id[np.unravel_index(ham.argmin(), ham.shape)]) else "ids"
        raise ValueError(
            f"family violates min Hamming {min_h}: measured {got} ({where})")
    return got


_C_INT_ARRAY = re.compile(
    r"(?:static\s+)?(?:const\s+)?u?int\d+_t\s+(\w+)\s*\[\s*\d*\s*\]\s*=\s*"
    r"\{([^}]*)\}", re.S)
_C_FIELD = re.compile(r"->\s*(\w+)\s*=\s*([\w.+-]+)\s*;")
_C_ELEM_ASSIGN = re.compile(
    r"->\s*(codes|bit_x|bit_y)\s*\[\s*(\d+)\s*\]\s*=\s*"
    r"(0[xX][0-9a-fA-F]+|-?\d+)\s*(?:UL|LL|ULL|L|u)?\s*;")


def _parse_c_table(text: str) -> dict:
    """Parse an apriltag3 family C source (both generator styles: static
    brace-initialized arrays, and per-element tf->codes[i]/bit_x[i]
    assignments). Returns dict with codes0 (n,) uint64, bit_x, bit_y,
    width_at_border, total_width, reversed_border, h, nbits, name."""
    out: dict = {}
    arrays: dict[str, list] = {}
    for m in _C_INT_ARRAY.finditer(text):
        vals = [v.strip().rstrip("uUlL") for v in m.group(2).split(",")]
        vals = [v for v in vals if v]
        arrays[m.group(1)] = [int(v, 0) for v in vals]
    elems: dict[str, dict[int, int]] = {}
    for m in _C_ELEM_ASSIGN.finditer(text):
        elems.setdefault(m.group(1), {})[int(m.group(2))] = int(m.group(3), 0)
    for fld, slot in elems.items():
        arrays.setdefault(fld, [slot[i] for i in range(len(slot))])
    fields = {}
    for m in _C_FIELD.finditer(text):
        if m.group(2).lstrip("+-").isdigit():
            fields[m.group(1)] = int(m.group(2))
        elif m.group(2) in ("true", "false"):
            fields[m.group(1)] = m.group(2) == "true"
    name = None
    nm = re.search(r'strdup\s*\(\s*"([^"]+)"\s*\)', text)
    if nm:
        name = nm.group(1)
    codes = arrays.get("codedata") or arrays.get("codes")
    if codes is None:
        raise ValueError("no code table found (codedata[]/codes[] array or "
                         "tf->codes[i] assignments)")
    out["codes0"] = np.array(codes, np.uint64)
    out["bit_x"] = arrays.get("bit_x")
    out["bit_y"] = arrays.get("bit_y")
    out["width_at_border"] = fields.get("width_at_border")
    out["total_width"] = fields.get("total_width")
    out["reversed_border"] = bool(fields.get("reversed_border", False))
    out["h"] = fields.get("h")
    out["nbits"] = fields.get("nbits")
    out["name"] = name
    return out


def _parse_csv_table(text: str) -> dict:
    """CSV/plain-text format: '# key: value' metadata comments (nbits,
    width_at_border, total_width, reversed_border, h, name, bit_x, bit_y —
    the last two as comma-separated int lists) followed by one hex or
    decimal code per line."""
    meta: dict = {}
    codes = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            if ":" in line:
                k, v = line[1:].split(":", 1)
                meta[k.strip()] = v.strip()
            continue
        codes.append(int(line.rstrip(","), 0))
    out: dict = {"codes0": np.array(codes, np.uint64)}
    for k in ("nbits", "width_at_border", "total_width", "h"):
        out[k] = int(meta[k]) if k in meta else None
    out["reversed_border"] = meta.get(
        "reversed_border", "false").lower() in ("1", "true", "yes")
    out["name"] = meta.get("name")
    for k in ("bit_x", "bit_y"):
        out[k] = ([int(v) for v in meta[k].split(",")]
                  if k in meta else None)
    return out


def load_external_table(path: str, name: str | None = None,
                        min_hamming: int | None = None,
                        register: bool = True) -> TagFamily:
    """Load a user-supplied official tag family table and register it.

    Drop-in path for the official reversed-border families the repo cannot
    ship (tagCircle21h7/49h12, tagStandard41h12/52h13, tagCustom48h12 —
    reference roster at apriltag_utils.cu:10-33): copy the official
    apriltag3 C source (e.g. ``tagStandard41h12.c`` from
    github.com/AprilRobotics/apriltag) next to your config and call
    ``load_external_table(path)`` (or set it up at launch); the family then
    works by name in :class:`DetectorConfig`. Also accepts a CSV (one code
    per line, '# key: value' metadata comments).

    Parses the bit layout (bit_x/bit_y), derives the four rotation readings
    geometrically from it, and VERIFIES the family's minimum Hamming
    distance over all id/rotation pairs before registering — a corrupted or
    hand-edited table fails loudly here instead of silently misdecoding on
    the field. min_hamming defaults to the 'h' field / the trailing 'h<N>'
    of the family name.
    """
    with open(path) as f:
        text = f.read()
    p = _parse_c_table(text) if re.search(
        r"(codedata|->\s*codes)", text) else _parse_csv_table(text)
    fam_name = name or p["name"] or os.path.splitext(
        os.path.basename(path))[0]
    h = min_hamming if min_hamming is not None else p["h"]
    if h is None:
        m = re.search(r"h(\d+)$", fam_name)
        if not m:
            raise ValueError("minimum Hamming distance not given (no 'h' "
                             "field, no h<N> name suffix, no min_hamming=)")
        h = int(m.group(1))
    codes0 = p["codes0"]
    nbits = p["nbits"] or (len(p["bit_x"]) if p["bit_x"] else None)
    if nbits is None:
        raise ValueError("nbits not given and no bit_x layout to infer from")
    if p["bit_x"] is not None:
        if p["bit_y"] is None or len(p["bit_x"]) != len(p["bit_y"]):
            raise ValueError("bit_x/bit_y layout arrays disagree")
        bit_xy = np.stack([np.asarray(p["bit_x"], np.int64),
                           np.asarray(p["bit_y"], np.int64)], -1)
    else:
        g = int(round(nbits ** 0.5))
        if g * g != nbits:
            raise ValueError(f"nbits={nbits} is not a dense grid and no "
                             "bit_x/bit_y layout was given")
        i = np.arange(nbits)
        bit_xy = np.stack([1 + i % g, 1 + i // g], -1).astype(np.int64)
    wb = p["width_at_border"]
    if wb is None:
        wb = int(bit_xy.max()) + 2 if p["bit_x"] is None else None
    if wb is None:
        raise ValueError("width_at_border not given")
    tw = p["total_width"] or max(wb + 2,
                                 int(bit_xy.max()) - int(bit_xy.min()) + 3)
    dense_g = 0
    dense = False
    g = int(round(nbits ** 0.5))
    if g * g == nbits and wb == g + 2 and tw == wb + 2:
        expect = np.stack([1 + np.arange(nbits) % g,
                           1 + np.arange(nbits) // g], -1)
        dense = bool((bit_xy == expect).all())
    if dense:
        dense_g = g
    codes = _codes_all_rotations(codes0, bit_xy, wb)
    verify_min_hamming(codes, nbits, int(h))
    fam = TagFamily(
        name=fam_name, grid_size=dense_g, min_hamming=int(h), codes=codes,
        reversed_border=p["reversed_border"],
        bit_xy=None if dense else bit_xy,
        width_at_border_=0 if dense else int(wb),
        total_width_=0 if (dense and tw == wb + 2) else int(tw))
    if register:
        register_family(fam)
    return fam
