"""Interval and path bookkeeping of the propagation stage, on the host.

Counterpart of ``fresco_tpu/propagate/sequence.py`` (the reference's
``VideoSequence``, src/ebsynth/blender/video_sequence.py:5-187): the on-disk
layout of a blending run -- video/ input frames, keys/ stylized keyframes,
per-interval out_<k>/ synthesis outputs, tmp/ guide and flow caches,
blend/ results -- and the forward/backward frame-path sequences of each
keyframe interval, with the same paths and sequences as the JAX class.
``blend_video`` keeps everything in memory and needs only the npz caches;
this class gives scripts the reference-compatible file organization.
"""
from __future__ import annotations

import os
import shutil
from dataclasses import dataclass, field


@dataclass
class VideoSequence:
    base_dir: str
    key_ind: list[int]
    input_subdir: str = "video"
    key_subdir: str = "keys"
    tmp_subdir: str = "tmp"
    blending_out_subdir: str = "blend"
    input_format: str = "%04d.png"
    key_format: str = "%04d.png"
    out_subdir_format: str = "out_%d"
    output_format: str = "%04d.png"
    _made: bool = field(default=False, repr=False)

    def __post_init__(self):
        self.input_dir = os.path.join(self.base_dir, self.input_subdir)
        self.key_dir = os.path.join(self.base_dir, self.key_subdir)
        self.tmp_dir = os.path.join(self.base_dir, self.tmp_subdir)
        self.blending_dir = os.path.join(self.base_dir, self.blending_out_subdir)
        self.make_dirs()

    # --- properties (video_sequence.py:38-55) -----------------------------
    @property
    def beg_frame(self) -> int:
        return self.key_ind[0]

    @property
    def end_frame(self) -> int:
        return self.key_ind[-1]

    @property
    def n_seq(self) -> int:
        return len(self.key_ind) - 1

    def interval(self, i: int) -> int:
        return self.get_sequence_beg_id(i + 1) - self.get_sequence_beg_id(i)

    def get_sequence_beg_id(self, i: int) -> int:
        return self.key_ind[i]

    # --- per-frame paths ---------------------------------------------------
    def get_input_img(self, i: int) -> str:
        return os.path.join(self.input_dir, self.input_format % i)

    def get_key_img(self, seq_i: int) -> str:
        return os.path.join(
            self.key_dir, self.key_format % self.get_sequence_beg_id(seq_i)
        )

    def get_blending_img(self, i: int) -> str:
        return os.path.join(self.blending_dir, self.output_format % i)

    # --- per-interval sequences (video_sequence.py:63-152) -----------------
    def _ids(self, seq_i: int, is_forward: bool) -> list[int]:
        """Reference-exact frame ids (video_sequence.py:63-75): the
        forward chain covers beg..end-1 (the interval's own key plus its
        in-betweens; the NEXT key belongs to the next interval), the
        backward chain end..beg+1 — note it is NOT the forward list
        reversed."""
        beg = self.get_sequence_beg_id(seq_i)
        end = self.get_sequence_beg_id(seq_i + 1)
        if is_forward:
            return list(range(beg, end))
        return list(range(end, beg, -1))

    def get_input_sequence(self, seq_i: int, is_forward: bool = True):
        return [self.get_input_img(i) for i in self._ids(seq_i, is_forward)]

    def get_output_sequence(self, seq_i: int, is_forward: bool = True):
        sub = self.out_subdir(seq_i if is_forward else seq_i + 1)
        return [
            os.path.join(sub, self.output_format % i)
            for i in self._ids(seq_i, is_forward)
        ]

    def _guide_sequence(self, seq_i, is_forward, prefix):
        sub = self.tmp_out_subdir(seq_i if is_forward else seq_i + 1)
        return [
            os.path.join(sub, prefix + self.output_format % i)
            for i in self._ids(seq_i, is_forward)
        ]

    def get_temporal_sequence(self, seq_i: int, is_forward: bool = True):
        return self._guide_sequence(seq_i, is_forward, "temporal_")

    def get_edge_sequence(self, seq_i: int, is_forward: bool = True):
        return self._guide_sequence(seq_i, is_forward, "edge_")

    def get_pos_sequence(self, seq_i: int, is_forward: bool = True):
        return self._guide_sequence(seq_i, is_forward, "pos_")

    def get_flow_sequence(self, seq_i: int, is_forward: bool = True):
        """Flow cache paths (video_sequence.py:138-152): forward chains
        store flow_f_<id>.npy for ids beg..end-2 (one per consecutive
        pair of the beg..end-1 chain), backward flow_b_<id>.npy for
        end..beg+2."""
        beg = self.get_sequence_beg_id(seq_i)
        end = self.get_sequence_beg_id(seq_i + 1)
        if is_forward:
            return [
                os.path.join(self.tmp_dir, "flow_f_%04d.npy" % i)
                for i in range(beg, end - 1)
            ]
        return [
            os.path.join(self.tmp_dir, "flow_b_%04d.npy" % i)
            for i in range(end, beg + 1, -1)
        ]

    # --- directory lifecycle (video_sequence.py:57-61,180-187) -------------
    def out_subdir(self, key_i: int) -> str:
        return os.path.join(
            self.base_dir, self.out_subdir_format % self.get_sequence_beg_id(key_i)
        )

    def tmp_out_subdir(self, key_i: int) -> str:
        return os.path.join(
            self.tmp_dir, self.out_subdir_format % self.get_sequence_beg_id(key_i)
        )

    def make_dirs(self) -> None:
        os.makedirs(self.base_dir, exist_ok=True)
        os.makedirs(self.blending_dir, exist_ok=True)
        os.makedirs(self.tmp_dir, exist_ok=True)
        for i in range(self.n_seq + 1):
            os.makedirs(self.out_subdir(i), exist_ok=True)
            os.makedirs(self.tmp_out_subdir(i), exist_ok=True)
        self._made = True

    def remove_out_and_tmp(self) -> None:
        for i in range(self.n_seq + 1):
            sub = self.out_subdir(i)
            if os.path.isdir(sub):
                shutil.rmtree(sub)
        if os.path.isdir(self.tmp_dir):
            shutil.rmtree(self.tmp_dir)
