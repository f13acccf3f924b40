"""The port's browser viewer (``tools/viz_server.py``) against the JAX
package's, on one output directory of a port run (36x48, four frames, a
checkpoint every second frame and a mesh at resolution 24): the two servers
answer ``GET /``, ``/state.json`` and ``/mesh.bin`` with the same bytes, and
a later checkpoint and mesh move both to ``mesh_version`` 2."""

import json
import os
import shutil
import urllib.request

import numpy as np
import pytest

from evennicer_slam_tpu.tools import viz_server as jvs
from evennicer_slam_tpu_torch.mesh.trimesh_lite import Mesh
from evennicer_slam_tpu_torch.slam.pipeline import EvenNICERSLAM
from evennicer_slam_tpu_torch.tools import viz_server as tvs
from torch_parity import cap_threads
from torch_pipeline_parity import tiny_cfg

cap_threads()


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("viewer")
    cfg = tiny_cfg(str(tmp / "scene"), 4, events=False)
    cfg["data"]["output"] = str(tmp / "out")
    cfg["meshing"]["resolution"] = 24
    slam = EvenNICERSLAM(cfg, device="cpu")
    slam.run()
    return slam


def get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.read()


def test_normals_and_packing_equal_the_jax_functions(run_dir):
    mesh = Mesh.load(os.path.join(run_dir.output, "mesh", "final_mesh.ply"))
    assert len(mesh.faces) > 100
    np.testing.assert_array_equal(tvs.vertex_normals(mesh.vertices, mesh.faces),
                                  jvs.vertex_normals(mesh.vertices, mesh.faces))
    assert tvs.pack_mesh(mesh, 3) == jvs.pack_mesh(mesh, 3)
    empty = tvs._EmptyMesh()
    assert tvs.pack_mesh(empty, 0) == jvs.pack_mesh(jvs._EmptyMesh(), 0)


def test_both_servers_answer_with_the_same_bytes(run_dir, tmp_path):
    out = str(tmp_path / "out")
    shutil.copytree(run_dir.output, out)
    for name in ("00003.npz", "00003.keyframes.pkl"):  # written again below
        os.remove(os.path.join(out, "ckpts", name))
    servers = [mod.serve(out, port=0, poll_s=3600.0, blocking=False) for mod in (tvs, jvs)]
    try:
        ports = [httpd.server_address[1] for httpd, _ in servers]
        page = [get(p, "/") for p in ports]
        assert page[0] == page[1] == jvs.PAGE.encode()
        state = [get(p, "/state.json") for p in ports]
        assert state[0] == state[1]
        s = json.loads(state[0])
        assert s["idx"] == 2 and s["mesh_version"] == 1 and len(s["est"]) == 3
        np.testing.assert_allclose(s["est"],
                                   np.round(run_dir.estimate_c2w_list[:3, :3, 3], 4))
        mesh = [get(p, "/mesh.bin") for p in ports]
        assert mesh[0] == mesh[1]
        magic, version, nv, nf = np.frombuffer(mesh[0][:16], "<u4")
        assert (magic, version, nv, nf) == (0x4D455348, 1, s["n_verts"], s["n_faces"])
        assert len(mesh[0]) == 16 + nv * (12 + 12 + 4) + nf * 12

        # a later checkpoint and a later mesh: both servers move to version 2
        run_dir.logger.ckpt_dir = os.path.join(out, "ckpts")
        run_dir.logger.log(run_dir, 3)
        later = Mesh.load(os.path.join(out, "mesh", "final_mesh.ply"))
        later.update_faces(np.arange(len(later.faces)) % 2 == 0)
        later.export(os.path.join(out, "mesh", "zz_mesh.ply"))
        for _, watcher in servers:
            watcher.refresh()
        state = [get(p, "/state.json") for p in ports]
        assert state[0] == state[1]
        s2 = json.loads(state[0])
        assert s2["mesh_version"] == 2 and s2["mesh_path"] == "zz_mesh.ply"
        assert s2["n_faces"] == len(later.faces) and s2["idx"] == 3 and len(s2["est"]) == 4
        assert get(ports[0], "/mesh.bin") == get(ports[1], "/mesh.bin")
        with pytest.raises(urllib.error.HTTPError):
            get(ports[0], "/nothing")
    finally:
        for httpd, watcher in servers:
            httpd.shutdown()
            watcher.stop()
