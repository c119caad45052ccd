"""Port vs JAX: the maze, sudoku and protein data of the port.

- The C++ generators: the port builds its own copy, csrc/datagen.cpp,
  through `ctdd_tpu_torch.data.native` into csrc/build/, and the JAX package
  builds native/datagen.cpp through its own loader. Both must build here
  (a C++ compiler is present), and their boards are equal bit for bit for
  several seeds, with `random_transform` on and off.
- The numpy generators (`use_native=False`), the relation encoding, the
  pool seeds, the batch iterator and the pools' `regenerate(epoch)`, and the
  protein stand-in pool: equal to JAX's, exactly.
"""

import re

import numpy as np
import pytest

from ctdd_tpu.data import loaders as jax_loaders
from ctdd_tpu.data import maze as jax_maze
from ctdd_tpu.data import native as jax_native
from ctdd_tpu.data import protein as jax_protein
from ctdd_tpu.data import sudoku as jax_sudoku
from ctdd_tpu_torch.config.presets import get_preset
from ctdd_tpu_torch.data import loaders, maze, native, protein, sudoku

SEEDS = [0, 1, 12345, 2**31 - 1]


def _code(path) -> str:
    """The C++ text without its // comments and blank lines."""
    lines = (re.sub(r"//.*", "", line).rstrip() for line in open(path))
    return "\n".join(line for line in lines if line)


def test_the_ports_generator_source_is_a_copy_of_the_jax_source():
    assert _code(native.SOURCE) == _code(native.SOURCE.parents[2] / "native" / "datagen.cpp")


def test_both_libraries_build_from_source():
    path = native.build()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.name.startswith("datagen-") and path.suffix == ".so"
    assert native.load() is not None
    assert jax_native.available(), "the JAX package's native/datagen.cpp did not build"


@pytest.mark.parametrize("random_transform", [True, False])
@pytest.mark.parametrize("seed", SEEDS)
def test_native_mazes_equal_jax(seed, random_transform):
    want = jax_native.maze_gen_native(40, random_transform=random_transform, seed=seed)
    got = native.maze_gen_native(40, random_transform=random_transform, seed=seed)
    assert got.shape == want.shape == (40, 1, 15, 15) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert maze.maze_acc(got) == 1.0


@pytest.mark.parametrize("seed", SEEDS)
def test_native_sudoku_equal_jax(seed):
    want = jax_native.sudoku_gen_native(64, seed=seed)
    got = native.sudoku_gen_native(64, seed=seed)
    assert got.shape == want.shape == (64, 81) and got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert sudoku.sudoku_acc(got) == 1.0


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("random_transform", [True, False])
def test_maze_gen_equals_jax(use_native, random_transform):
    """`maze_gen` through either generator; they differ from one seed."""
    kw = dict(random_transform=random_transform, seed=7, use_native=use_native)
    got = maze.maze_gen(12, **kw)
    np.testing.assert_array_equal(got, jax_maze.maze_gen(12, **kw))
    other = maze.maze_gen(12, **{**kw, "use_native": not use_native})
    assert not np.array_equal(got, other)


@pytest.mark.parametrize("use_native", [True, False])
def test_gen_sudoku_equals_jax(use_native):
    got = sudoku.gen_sudoku(10, seed=3, use_native=use_native)
    assert got.shape == (10, 9, 9) and got.min() == 1 and got.max() == 9
    np.testing.assert_array_equal(got, jax_sudoku.gen_sudoku(10, seed=3, use_native=use_native))


def test_numpy_maze_generator_equals_jax():
    rng_a, rng_b = np.random.RandomState(4), np.random.RandomState(4)
    for _ in range(5):
        grid = maze.generate_maze(rng=rng_a)
        want = jax_maze.generate_maze(rng=rng_b)
        np.testing.assert_array_equal(grid, want)
        assert maze._open_entries(grid, True, rng_a) == jax_maze._open_entries(want, True, rng_b)
        np.testing.assert_array_equal(grid, want)


def test_relative_encoding_equals_jax():
    got = sudoku.define_relative_encoding()
    np.testing.assert_array_equal(got, jax_sudoku.define_relative_encoding())
    assert got.shape == (81, 81, 27) and got.dtype == np.float32


@pytest.mark.parametrize("base", [0, 5])
def test_mix_pool_seed_equals_jax(base):
    for epoch in range(6):
        assert loaders.mix_pool_seed(base, epoch) == jax_loaders.mix_pool_seed(base, epoch)


@pytest.mark.parametrize("drop_last", [True, False])
def test_iterate_batches_drop_last_equals_jax(drop_last):
    data = np.arange(22 * 3).reshape(22, 3)
    ours = loaders.iterate_batches(loaders.ArrayDataset(data), 5, seed=2, drop_last=drop_last)
    theirs = jax_loaders.iterate_batches(jax_loaders.ArrayDataset(data), 5, seed=2,
                                         drop_last=drop_last)
    sizes = []
    for _ in range(12):
        (a, _), (b, _) = next(ours), next(theirs)
        np.testing.assert_array_equal(a, b)
        sizes.append(len(a))
    assert (2 in sizes) is not drop_last


def test_pools_regenerate_like_jax():
    ours = maze.MazePoolDataset(24, random_transform=True, seed=3)
    theirs = jax_maze.MazePoolDataset(24, random_transform=True, seed=3)
    np.testing.assert_array_equal(ours.data, theirs.data)
    for epoch in (1, 4):
        np.testing.assert_array_equal(ours.regenerate(epoch), theirs.regenerate(epoch))
    s_ours, s_theirs = sudoku.SudokuPoolDataset(32, seed=0), jax_sudoku.SudokuPoolDataset(32, seed=0)
    np.testing.assert_array_equal(s_ours.data, s_theirs.data)
    first = s_ours.data.copy()
    pool = s_ours.regenerate(4)
    np.testing.assert_array_equal(pool, s_theirs.regenerate(4))
    assert pool.shape == (32, 81) and not np.array_equal(pool, first)
    np.testing.assert_array_equal(pool, sudoku.SudokuPoolDataset(32, seed=0).regenerate(4))


@pytest.mark.parametrize("preset,n", [("tauUnet_maze", 6400), ("sudoku", 12800)])
def test_registered_datasets_build_the_preset_pools(preset, n, monkeypatch):
    """`get_dataset` reaches Maze3S and SudokuDataset; their pool sizes are
    the presets' (the generators are stubbed here: the full pools are
    generated in the tests above and on the card)."""
    calls = []
    monkeypatch.setattr(maze, "maze_gen", lambda limit, **kw: calls.append(limit)
                        or np.zeros((limit, 1, 15, 15), np.uint8))
    monkeypatch.setattr(sudoku, "gen_sudoku", lambda num, seed=None: calls.append(num)
                        or np.ones((num, 9, 9), np.int32))
    ds = loaders.get_dataset(get_preset(preset))
    assert calls == [n] and len(ds) == n and hasattr(ds, "regenerate")


def test_maze3s_complete_equals_jax():
    from ctdd_tpu_torch import registry

    cfg = get_preset("tauUnet_maze")
    cfg.data.limit, cfg.data.seed = 8, 2
    got = registry.datasets.get("Maze3SComplete")(cfg)
    np.testing.assert_array_equal(got.data, jax_maze.maze_gen(8, random_transform=True, seed=2))


def test_protein_stand_in_pool_equals_jax(tmp_path):
    cfg = get_preset("hollow_protein")
    cfg.data.location = str(tmp_path / "absent.npy")
    cfg.data.num_samples = 300
    ds = loaders.get_dataset(cfg)
    np.testing.assert_array_equal(ds.data, jax_protein._synthetic_pool(300, 48, 21))
    assert ds.data.shape == (300, 48) and ds.data.dtype == np.int32
    assert ds.data.min() >= 0 and ds.data.max() == protein.CHAR2IDX["-"] == 20
    seq = protein.numbers_to_sequence(ds.data[0])
    assert protein.sequence_to_numbers(seq) == list(ds.data[0])
    assert protein.pad_sequence("ARN", 6) == jax_protein.pad_sequence("ARN", 6) == "ARN---"
    np.save(tmp_path / "real.npy", ds.data[:5].astype(np.int64))
    cfg.data.location = str(tmp_path / "real.npy")
    cfg.data.name = "ProteinStream"
    got = loaders.get_dataset(cfg).data
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ds.data[:5])
