"""Data: the host data pipeline (the port's copies of emox/data/: synthetic
fixtures, face/pose utilities, augmentation, offline precompute, sharded
records, the stage-keyed dataset and loader) and the CLIP tokenizer.
Numpy throughout, apart from the trained face providers (FaceHelper)."""

from emox_torch.data.dataset import DataLoader, EMODataset
from emox_torch.data.face import FaceHelper, head_pose_from_landmarks, pose_velocities
from emox_torch.data.fixtures import make_synthetic_clip, write_fixture_dataset
from emox_torch.data.precompute import precompute_clip, precompute_dataset
from emox_torch.data.tokenizer import CLIPTokenizer, fallback_vocab

__all__ = [
    "CLIPTokenizer",
    "DataLoader",
    "EMODataset",
    "FaceHelper",
    "fallback_vocab",
    "head_pose_from_landmarks",
    "make_synthetic_clip",
    "pose_velocities",
    "precompute_clip",
    "precompute_dataset",
    "write_fixture_dataset",
]
