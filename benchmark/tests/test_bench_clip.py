"""The seeded clip generator."""

import numpy as np
import pytest

from benchmark import clip

SMALL = {"region_sizes": [8, 10, 12, 14, 16, 18]}


def test_same_seed_same_pictures_and_large_seeds_work():
    a = clip.make_clip(2 ** 31 + 12345, 64, 48, 3, SMALL)
    b = clip.make_clip(2 ** 31 + 12345, 64, 48, 3, SMALL)
    for pa, pb in zip(a, b):
        for x, y in zip(pa, pb):
            assert x.dtype == np.uint8 and np.array_equal(x, y)
    assert a[0][0].shape == (48, 64) and a[0][1].shape == (24, 32)


def test_seeds_differ_but_keep_their_detail():
    """The same detail (mean absolute gradient) within 5 % for every
    seed: the seed moves the work around, it does not change it."""
    def detail(y):
        y = y.astype(np.int32)
        return np.abs(np.diff(y, axis=1)).mean() + \
            np.abs(np.diff(y, axis=0)).mean()
    clips = [clip.make_clip(seed, 416, 240, 2) for seed in (1, 2, 3, 4)]
    assert not np.array_equal(clips[0][0][0], clips[1][0][0])
    d = [detail(pic[0]) for c in clips for pic in c]
    assert max(d) / min(d) < 1.05


def test_regions_move_between_pictures():
    pics = clip.make_clip(5, 128, 64, 2, SMALL)
    assert not np.array_equal(pics[0][0], pics[1][0])


def test_regions_too_large_for_the_picture_are_refused():
    with pytest.raises(ValueError):
        clip.make_clip(5, 64, 48, 1)


def test_content_seed_fixes_the_pictures_and_the_seed_their_order():
    p = dict(SMALL, content_seed=77)
    a = clip.make_clip(1, 64, 48, 5, p)
    b = clip.make_clip(2, 64, 48, 5, p)
    key = lambda pics: sorted(x[0].tobytes() for x in pics)
    assert key(a) == key(b)
    assert [x[0].tobytes() for x in a] != [x[0].tobytes() for x in b]
    assert [x[0].tobytes() for x in clip.make_clip(1, 64, 48, 5, p)] == \
        [x[0].tobytes() for x in a]
