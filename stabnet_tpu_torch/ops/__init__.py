"""Geometry and warp ops (PyTorch port of stabnet_tpu.ops)."""

from stabnet_tpu_torch.ops.crop import max_clear_rect
from stabnet_tpu_torch.ops.homography import (
    apply_homography,
    cell_src_corners,
    mesh_cell_corners,
    mesh_to_homographies,
    solve_dlt,
)
from stabnet_tpu_torch.ops.mesh import base_mesh, cell_pts, theta_to_mesh
from stabnet_tpu_torch.ops.resize import resize_bilinear_bhw, resize_matrix
from stabnet_tpu_torch.ops.warp import (
    MeshTables,
    WarpResult,
    bilinear_sample,
    black_mask,
    dense_maps,
    mesh_tables,
    transformer,
)
