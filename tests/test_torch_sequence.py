"""fresco_torch.propagate.sequence.VideoSequence against fresco_tpu's: the
same directories made, and every path and sequence equal (exact)."""
import os

import pytest

from fresco_torch.propagate.sequence import VideoSequence as TorchSeq
from fresco_tpu.propagate.sequence import VideoSequence as JaxSeq

GETTERS = ("get_input_sequence", "get_output_sequence", "get_temporal_sequence", "get_edge_sequence",
           "get_pos_sequence", "get_flow_sequence")


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, n), root) for d, dirs, _ in os.walk(root) for n in dirs)


@pytest.mark.parametrize("key_ind,kw", [([0, 5, 9], {}), ([3, 4, 12, 20], dict(input_format="%05d.jpg",
                                                                               out_subdir_format="o%d"))])
def test_paths_and_sequences_match_jax(tmp_path, key_ind, kw):
    t = TorchSeq(str(tmp_path / "t"), key_ind, **kw)
    j = JaxSeq(str(tmp_path / "j"), key_ind, **kw)
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")
    rel = lambda p, root: os.path.relpath(p, root)  # noqa: E731
    for attr in ("beg_frame", "end_frame", "n_seq"):
        assert getattr(t, attr) == getattr(j, attr)
    for seq_i in range(j.n_seq):
        assert t.interval(seq_i) == j.interval(seq_i)
        assert rel(t.get_key_img(seq_i), t.base_dir) == rel(j.get_key_img(seq_i), j.base_dir)
        for fwd in (True, False):
            for g in GETTERS:
                a = [rel(p, t.base_dir) for p in getattr(t, g)(seq_i, fwd)]
                b = [rel(p, j.base_dir) for p in getattr(j, g)(seq_i, fwd)]
                assert a == b, (g, seq_i, fwd)
    for i in range(key_ind[0], key_ind[-1] + 1):
        assert rel(t.get_input_img(i), t.base_dir) == rel(j.get_input_img(i), j.base_dir)
        assert rel(t.get_blending_img(i), t.base_dir) == rel(j.get_blending_img(i), j.base_dir)
    t.remove_out_and_tmp()
    j.remove_out_and_tmp()
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")
