"""Dataset loaders and in-memory scene generators (numpy, host-side)."""

from reart_tpu_torch.data.robot import RobotSequence
from reart_tpu_torch.data.synth import make_robot_sample, make_toy_robot_sample
