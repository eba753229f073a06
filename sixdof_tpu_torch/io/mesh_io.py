"""Triangle-mesh and point-cloud containers + OBJ/PLY loading.

Port of `sixdof_tpu/io/mesh_io.py` (the loaders and containers the pose and
capture paths use, and the OBJ and PLY writers), numpy only.  A textured
OBJ's `map_Kd` image is read as PNG (`io/png.py`) or JPEG (`io/jpeg.py`)
and written as PNG; a texture in any other format raises, since dropping
it would change the rendered colours.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class PointCloud:
    """Minimal Open3D-PointCloud stand-in: numpy points/colors/normals."""

    points: np.ndarray  # (N,3) float64
    colors: Optional[np.ndarray] = None  # (N,3) float in [0,1]
    normals: Optional[np.ndarray] = None  # (N,3)

    def __post_init__(self):
        self.points = np.asarray(self.points, dtype=np.float64).reshape(-1, 3)
        if self.colors is not None:
            self.colors = np.asarray(self.colors, dtype=np.float64).reshape(-1, 3)
            if self.colors.size and self.colors.max() > 1.0:
                self.colors = self.colors / 255.0
        if self.normals is not None:
            self.normals = np.asarray(self.normals, dtype=np.float64).reshape(-1, 3)

    def __len__(self):
        return len(self.points)

    def copy(self):
        return PointCloud(
            self.points.copy(),
            None if self.colors is None else self.colors.copy(),
            None if self.normals is None else self.normals.copy(),
        )

    def transform(self, tf):
        """In-place homogeneous transform (Open3D semantics)."""
        tf = np.asarray(tf)
        self.points = self.points @ tf[:3, :3].T + tf[:3, 3]
        if self.normals is not None:
            self.normals = self.normals @ tf[:3, :3].T
        return self

    def paint_uniform_color(self, color):
        self.colors = np.tile(np.asarray(color, dtype=np.float64)[None], (len(self.points), 1))
        return self

    def select_by_index(self, idx, invert=False):
        mask = np.zeros(len(self.points), dtype=bool)
        mask[np.asarray(idx, dtype=np.int64)] = True
        if invert:
            mask = ~mask
        return PointCloud(
            self.points[mask],
            None if self.colors is None else self.colors[mask],
            None if self.normals is None else self.normals[mask],
        )


@dataclass
class TriMesh:
    """Minimal trimesh stand-in: vertices/faces + optional colours/uv/texture."""

    vertices: np.ndarray  # (V,3) float64
    faces: np.ndarray  # (F,3) int64
    vertex_colors: Optional[np.ndarray] = None  # (V,3) uint8-scale [0,255]
    uv: Optional[np.ndarray] = None  # (V,2)
    texture: Optional[np.ndarray] = None  # (H,W,3) uint8 RGB
    _vertex_normals: Optional[np.ndarray] = field(default=None, repr=False)

    def __post_init__(self):
        self.vertices = np.asarray(self.vertices, dtype=np.float64).reshape(-1, 3)
        self.faces = np.asarray(self.faces, dtype=np.int64).reshape(-1, 3)

    def copy(self):
        m = TriMesh(
            self.vertices.copy(),
            self.faces.copy(),
            None if self.vertex_colors is None else self.vertex_colors.copy(),
            None if self.uv is None else self.uv.copy(),
            None if self.texture is None else self.texture.copy(),
        )
        return m

    @property
    def triangles(self):  # Open3D-compatible alias
        return self.faces

    @property
    def face_normals(self):
        v0 = self.vertices[self.faces[:, 0]]
        v1 = self.vertices[self.faces[:, 1]]
        v2 = self.vertices[self.faces[:, 2]]
        n = np.cross(v1 - v0, v2 - v0)
        norm = np.linalg.norm(n, axis=-1, keepdims=True)
        return n / np.clip(norm, 1e-12, None)

    @property
    def vertex_normals(self):
        """Area-weighted vertex normals (computed once, cached)."""
        if self._vertex_normals is None:
            v0 = self.vertices[self.faces[:, 0]]
            v1 = self.vertices[self.faces[:, 1]]
            v2 = self.vertices[self.faces[:, 2]]
            fn = np.cross(v1 - v0, v2 - v0)  # area-weighted
            vn = np.zeros_like(self.vertices)
            for k in range(3):
                np.add.at(vn, self.faces[:, k], fn)
            norm = np.linalg.norm(vn, axis=-1, keepdims=True)
            self._vertex_normals = vn / np.clip(norm, 1e-12, None)
        return self._vertex_normals

    def compute_vertex_normals(self):
        _ = self.vertex_normals
        return self

    def apply_transform(self, tf):
        tf = np.asarray(tf)
        self.vertices = self.vertices @ tf[:3, :3].T + tf[:3, 3]
        self._vertex_normals = None
        return self

    transform = apply_transform  # Open3D-compatible alias

    def bounds(self):
        return np.stack([self.vertices.min(axis=0), self.vertices.max(axis=0)])

    def sample_points(self, n, seed=0):
        """Area-weighted uniform surface sampling -> PointCloud with normals."""
        rng = np.random.RandomState(seed)
        v0 = self.vertices[self.faces[:, 0]]
        v1 = self.vertices[self.faces[:, 1]]
        v2 = self.vertices[self.faces[:, 2]]
        area = np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1) / 2
        probs = area / area.sum()
        fid = rng.choice(len(self.faces), size=n, p=probs)
        r1 = np.sqrt(rng.rand(n, 1))
        r2 = rng.rand(n, 1)
        pts = (1 - r1) * v0[fid] + r1 * (1 - r2) * v1[fid] + r1 * r2 * v2[fid]
        fn = self.face_normals[fid]
        return PointCloud(pts, normals=fn)

    def export(self, path):
        save_mesh(path, self)
        return path

    def is_watertight(self):
        """True iff every undirected edge is shared by exactly two faces with
        opposite orientation (closed, consistently wound 2-manifold).  Gates
        backface culling in the rasterizer: for such meshes backfaces are
        always occluded, so culling halves raster work without changing the
        image (ops/rasterize.py render_batch(backface_cull=...))."""
        f = np.asarray(self.faces, dtype=np.int64)
        if len(f) == 0:
            return False
        n = int(f.max()) + 1
        directed = np.concatenate(
            [f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], axis=0
        )
        keys = directed[:, 0] * n + directed[:, 1]
        if len(np.unique(keys)) != len(keys):
            return False  # a directed edge repeats -> inconsistent winding
        rev = directed[:, 1] * n + directed[:, 0]
        return bool(np.isin(keys, rev).all())

    def signed_volume(self):
        """Divergence-theorem volume: positive iff a closed, consistently
        wound mesh is oriented OUTWARD.  Backface culling is only an identity
        for outward-wound closed meshes — an inward-wound closed mesh passes
        is_watertight() yet culling it keeps the far surface."""
        v0 = self.vertices[self.faces[:, 0]]
        v1 = self.vertices[self.faces[:, 1]]
        v2 = self.vertices[self.faces[:, 2]]
        return float(np.einsum("ij,ij->i", v0, np.cross(v1, v2)).sum() / 6.0)


# --------------------------------------------------------------------- OBJ --


def _read_texture(path):
    """A `map_Kd` image as (H,W,3) uint8 RGB, as PIL's ``convert("RGB")``
    gives it, told apart by its first bytes.  A JPEG decodes through
    `io/jpeg.py`; of a PNG, grey is replicated, alpha and palette
    transparency dropped, 16-bit grey clipped to 255 and other 16-bit
    samples shifted to their high byte; any other format raises rather
    than rendering the mesh without its texture."""
    from .jpeg import read_jpeg_rgb
    from .png import read_png

    with open(path, "rb") as f:
        head = f.read(8)
    if head[:3] == b"\xff\xd8\xff":
        return read_jpeg_rgb(path)
    if head != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: the texture is a {os.path.splitext(path)[1]!r} image; "
                         "PNG and JPEG textures are read (convert it to one of them)")
    img = read_png(path)
    if img.dtype == np.uint16:
        img = np.minimum(img, 255) if img.ndim == 2 else img >> 8
        img = img.astype(np.uint8)
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    return np.ascontiguousarray(img[..., 2::-1])  # BGR(A) -> RGB


def load_obj(path):
    """Parse a Wavefront OBJ (v / v-with-colour / vn / vt / f, and the
    texture a `mtllib` material names with `map_Kd`)."""
    verts, colors, uvs = [], [], []
    faces, face_uvs = [], []
    mtl_tex = None
    base = os.path.dirname(path)
    with open(path, "r") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "v":
                vals = [float(x) for x in parts[1:]]
                verts.append(vals[:3])
                if len(vals) >= 6:
                    colors.append(vals[3:6])
            elif tag == "vt":
                uvs.append([float(x) for x in parts[1:3]])
            elif tag == "f":
                idx, uv_idx = [], []
                for p in parts[1:]:
                    comps = p.split("/")
                    idx.append(int(comps[0]) - 1)
                    if len(comps) > 1 and comps[1]:
                        uv_idx.append(int(comps[1]) - 1)
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append([idx[0], idx[k], idx[k + 1]])
                    if uv_idx:
                        face_uvs.append([uv_idx[0], uv_idx[k], uv_idx[k + 1]])
            elif tag == "mtllib":
                mtl_path = os.path.join(base, parts[1])
                if os.path.exists(mtl_path):
                    with open(mtl_path) as mf:
                        for ml in mf:
                            mp = ml.split()
                            if mp and mp[0] == "map_Kd":
                                tex_path = os.path.join(base, mp[1])
                                if os.path.exists(tex_path):
                                    mtl_tex = _read_texture(tex_path)
    verts = np.array(verts, dtype=np.float64)
    faces = np.array(faces, dtype=np.int64) if faces else np.zeros((0, 3), np.int64)
    vc = None
    if colors:
        vc = (np.array(colors) * 255.0).clip(0, 255)
    uv = None
    if uvs and face_uvs:
        # one uv per vertex: the last face corner that names the vertex wins,
        # as numpy's fancy assignment in the JAX loader resolves it
        uv = np.zeros((len(verts), 2))
        uv[faces.reshape(-1)] = np.array(uvs)[np.array(face_uvs).reshape(-1)]
    return TriMesh(verts, faces, vertex_colors=vc, uv=uv, texture=mtl_tex)


def save_obj(path, mesh: TriMesh):
    """Write @mesh as OBJ; a textured mesh also gets `<name>.mtl` and the
    texture as `<name>_tex.png` (RGB) beside it."""
    textured = mesh.uv is not None and mesh.texture is not None
    with open(path, "w") as f:
        if textured:
            from .png import write_png_rgb8

            base = os.path.splitext(path)[0]
            name = os.path.basename(base)
            tex_name = f"{name}_tex.png"
            write_png_rgb8(os.path.join(os.path.dirname(path) or ".", tex_name),
                           np.asarray(mesh.texture, dtype=np.uint8))
            with open(f"{base}.mtl", "w") as mf:
                mf.write(f"newmtl material_0\nmap_Kd {tex_name}\n")
            f.write(f"mtllib {name}.mtl\nusemtl material_0\n")
        if mesh.vertex_colors is not None:
            vc = np.asarray(mesh.vertex_colors, dtype=np.float64)
            if vc.max() > 1:
                vc = vc / 255.0
            for v, c in zip(mesh.vertices, vc):
                f.write(f"v {v[0]} {v[1]} {v[2]} {c[0]} {c[1]} {c[2]}\n")
        else:
            for v in mesh.vertices:
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        if textured:
            for uv in mesh.uv:
                f.write(f"vt {uv[0]} {uv[1]}\n")
            for face in mesh.faces:
                f.write(f"f {face[0]+1}/{face[0]+1} {face[1]+1}/{face[1]+1} "
                        f"{face[2]+1}/{face[2]+1}\n")
        else:
            for face in mesh.faces:
                f.write(f"f {face[0]+1} {face[1]+1} {face[2]+1}\n")


# --------------------------------------------------------------------- PLY --

_PLY_DTYPES = {
    "char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
    "short": "i2", "ushort": "u2", "int16": "i2", "uint16": "u2",
    "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def load_ply(path):
    """Parse ascii / binary_little_endian PLY.  Returns PointCloud or TriMesh."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header\n") + len(b"end_header\n")
    header = data[:header_end].decode("ascii", errors="replace").splitlines()
    body = data[header_end:]

    fmt = None
    elements = []  # list of (name, count, [(prop_name, dtype) or ('list', idx_dtype, cnt_dtype, name)])
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append([parts[1], int(parts[2]), []])
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append(("list", _PLY_DTYPES[parts[2]], _PLY_DTYPES[parts[3]], parts[4]))
            else:
                elements[-1][2].append((parts[1], _PLY_DTYPES[parts[1]], parts[2]))

    parsed = {}
    if fmt == "ascii":
        tokens = body.decode("ascii").split("\n")
        li = 0
        for name, count, props in elements:
            rows = []
            for _ in range(count):
                while li < len(tokens) and not tokens[li].strip():
                    li += 1
                rows.append(tokens[li].split())
                li += 1
            if any(p[0] == "list" for p in props):
                parsed[name] = [[float(x) for x in r[1:]] for r in rows]
            else:
                arr = np.array(rows, dtype=np.float64)
                parsed[name] = {p[2]: arr[:, i] for i, p in enumerate(props)}
    elif fmt == "binary_little_endian":
        offset = 0
        for name, count, props in elements:
            if any(p[0] == "list" for p in props):
                # assume a single list property (faces)
                lp = props[0]
                cnt_dt = np.dtype("<" + lp[1])
                idx_dt = np.dtype("<" + lp[2])
                rows = []
                for _ in range(count):
                    n = int(np.frombuffer(body, dtype=cnt_dt, count=1, offset=offset)[0])
                    offset += cnt_dt.itemsize
                    rows.append(np.frombuffer(body, dtype=idx_dt, count=n, offset=offset).astype(np.int64))
                    offset += idx_dt.itemsize * n
                parsed[name] = rows
            else:
                dt = np.dtype([(p[2], "<" + p[1]) for p in props])
                arr = np.frombuffer(body, dtype=dt, count=count, offset=offset)
                offset += dt.itemsize * count
                parsed[name] = {p[2]: arr[p[2]].astype(np.float64) for p in props}
    else:
        raise ValueError(f"unsupported PLY format: {fmt}")

    vtx = parsed.get("vertex", {})
    pts = np.stack([vtx["x"], vtx["y"], vtx["z"]], axis=-1)
    colors = None
    if "red" in vtx:
        colors = np.stack([vtx["red"], vtx["green"], vtx["blue"]], axis=-1) / 255.0
    normals = None
    if "nx" in vtx:
        normals = np.stack([vtx["nx"], vtx["ny"], vtx["nz"]], axis=-1)

    if "face" in parsed and len(parsed["face"]):
        faces = []
        for row in parsed["face"]:
            row = np.asarray(row, dtype=np.int64)
            for k in range(1, len(row) - 1):
                faces.append([row[0], row[k], row[k + 1]])
        vc = None if colors is None else colors * 255.0
        return TriMesh(pts, np.array(faces, dtype=np.int64), vertex_colors=vc)
    return PointCloud(pts, colors=colors, normals=normals)


# ---------------------------------------------------------------- dispatch --


def load_mesh(path) -> TriMesh:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        return load_obj(path)
    if ext == ".ply":
        out = load_ply(path)
        if isinstance(out, PointCloud):
            raise ValueError(f"{path} contains no faces")
        return out
    raise ValueError(f"unsupported mesh format: {ext}")


def load_point_cloud(path) -> PointCloud:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".ply":
        out = load_ply(path)
        if isinstance(out, TriMesh):
            return PointCloud(out.vertices, colors=None)
        return out
    raise ValueError(f"unsupported point-cloud format: {ext}")


def save_ply(path, obj):
    """Write a PointCloud or a TriMesh as binary little-endian PLY: x y z
    float, then a cloud's normals and the colours as uchar (colours in [0,1]
    scaled to 0-255), and a mesh's faces as `list uchar int`, as the JAX
    package's save_ply writes them."""
    is_mesh = isinstance(obj, TriMesh)
    pts = obj.vertices if is_mesh else obj.points
    colors = obj.vertex_colors if is_mesh else obj.colors
    normals = None if is_mesh else obj.normals
    props = [("x", "f4"), ("y", "f4"), ("z", "f4")]
    if normals is not None:
        props += [("nx", "f4"), ("ny", "f4"), ("nz", "f4")]
    if colors is not None:
        props += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    names = {"f4": "float", "u1": "uchar"}
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {len(pts)}"]
    header += [f"property {names[dt]} {p}" for p, dt in props]
    if is_mesh:
        header += [f"element face {len(obj.faces)}", "property list uchar int vertex_indices"]
    header.append("end_header")
    rec = np.zeros(len(pts), dtype=[(p, "<" + dt) for p, dt in props])
    rec["x"], rec["y"], rec["z"] = np.asarray(pts).T
    if normals is not None:
        rec["nx"], rec["ny"], rec["nz"] = normals.T
    if colors is not None:
        c = np.asarray(colors, dtype=np.float64)
        if c.size and c.max() <= 1.0 + 1e-9:
            c = c * 255.0
        rec["red"], rec["green"], rec["blue"] = np.clip(c, 0, 255).astype(np.uint8).T
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(rec.tobytes())
        if is_mesh:
            tri = np.zeros(len(obj.faces), dtype=[("n", "u1"), ("v", "<i4", (3,))])
            tri["n"] = 3
            tri["v"] = np.asarray(obj.faces)
            f.write(tri.tobytes())


def save_mesh(path, mesh: TriMesh):
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        save_obj(path, mesh)
    elif ext == ".ply":
        save_ply(path, mesh)
    else:
        raise ValueError(f"unsupported mesh format: {ext}")


def save_point_cloud(path, pcd: PointCloud):
    save_ply(path, pcd)


def decimate_mesh(mesh: TriMesh, target_tris=None, voxel_size=None) -> TriMesh:
    """Vertex-clustering decimation for the raster.

    Clusters vertices on a uniform grid (cell size @voxel_size, or found by
    bisection so that the faces land at 0.7-1x @target_tris), collapses each
    cluster to its mean (colours and uv too), drops degenerate faces and
    repeated faces (the first kept, in face order).  A mesh already at or
    under @target_tris is returned as a copy.
    """
    v = np.asarray(mesh.vertices, dtype=np.float64)
    f = np.asarray(mesh.faces, dtype=np.int64)
    if len(f) == 0 or (target_tris is not None and len(f) <= target_tris):
        return mesh.copy()

    def cluster(vox):
        keys = np.floor(v / vox).astype(np.int64)
        keys -= keys.min(axis=0)
        dims = keys.max(axis=0) + 1
        flat = (keys[:, 0] * dims[1] + keys[:, 1]) * dims[2] + keys[:, 2]
        uniq, inverse, counts = np.unique(flat, return_inverse=True, return_counts=True)

        def mean_of(attr):
            if attr is None:
                return None
            out = np.zeros((len(uniq), attr.shape[1]), dtype=np.float64)
            np.add.at(out, inverse, np.asarray(attr, dtype=np.float64))
            return out / counts[:, None]

        nf = inverse[f]
        nf = nf[(nf[:, 0] != nf[:, 1]) & (nf[:, 1] != nf[:, 2]) & (nf[:, 0] != nf[:, 2])]
        _, first = np.unique(np.sort(nf, axis=1), axis=0, return_index=True)
        return TriMesh(mean_of(v), nf[np.sort(first)],
                       vertex_colors=mean_of(mesh.vertex_colors), uv=mean_of(mesh.uv),
                       texture=None if mesh.texture is None else mesh.texture.copy())

    if voxel_size is not None:
        return cluster(float(voxel_size))
    diag = float(np.linalg.norm(v.max(axis=0) - v.min(axis=0)))
    lo, hi = diag / 1000.0, diag / 2.0
    best = None
    for _ in range(20):
        mid = (lo + hi) / 2.0
        m = cluster(mid)
        if len(m.faces) > target_tris:
            lo = mid
        else:
            best, hi = m, mid
        if best is not None and 0.7 * target_tris <= len(best.faces) <= target_tris:
            break
    return best if best is not None else cluster(hi)
