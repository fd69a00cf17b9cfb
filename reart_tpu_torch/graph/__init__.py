"""Graph stage (reart_tpu/graph): edge costs, greedy MST, part merging,
relabelling and the tree edit distance. Tensor costs run on the device of
their inputs; the combinatorial structure is numpy and plain Python on the
host."""

from reart_tpu_torch.graph.costs import (
    compute_geo_cost,
    compute_joint_cost,
    compute_mean_screw_param,
    compute_relative_trans,
    compute_root_cost,
    compute_screw_cost,
    compute_screw_trans,
    compute_spatial_cost,
    fps_index_list,
    fps_sample_cano,
    frobenius_cost,
)
from reart_tpu_torch.graph.kinematics import (
    build_graph,
    edge_index2edges,
    extract_kinematic,
    to_dag,
)
from reart_tpu_torch.graph.mst import (
    denoise_seg_label,
    filter_seg_label,
    merge_graph,
    merging_wrapper,
    mst,
    mst_wrapper,
)
from reart_tpu_torch.graph.ted import compute_ted, find_root_node
