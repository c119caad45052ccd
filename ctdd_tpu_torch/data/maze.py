"""Maze data: the growing-tree generator, the BFS solver, the solvability
metric and the Maze3S datasets.

The port's copy of ctdd_tpu/data/maze.py (numpy, and the C++ generator of
data/native.py): boards are 15x15 (7x7 cells and walls) with states
0 = wall, 1 = solution path, 2 = corridor. `maze_gen` takes the C++
generator unless `use_native=False`; the two give different boards from one
seed, and a failed build of the C++ one raises (no quiet fallback).
"""

from __future__ import annotations

from collections import deque
from typing import Optional, Tuple

import numpy as np

from ctdd_tpu_torch import registry
from ctdd_tpu_torch.data.loaders import ArrayDataset, mix_pool_seed

WALL, PATH, WAY = 0, 1, 2


def generate_maze(
    dim_x: int = 7,
    dim_y: int = 7,
    weight_high: float = 99,
    weight_low: float = 97,
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    """Growing-tree maze on a (2*dim_y+1, 2*dim_x+1) grid, values {0, 2}.

    weight_low%% of steps extend the newest cell (long corridors); up to
    weight_high%% pick a random active cell; the rest pick the oldest —
    the same knobs as the reference's makeMazeGrowTree.
    """
    rng = rng or np.random.RandomState()
    H, W = 2 * dim_y + 1, 2 * dim_x + 1
    grid = np.zeros((H, W), np.int8)
    visited = np.zeros((dim_y, dim_x), bool)
    start = (rng.randint(dim_y), rng.randint(dim_x))
    visited[start] = True
    grid[2 * start[0] + 1, 2 * start[1] + 1] = WAY
    active = [start]
    while active:
        r = rng.uniform(0, 100)
        if r < weight_low:
            idx = len(active) - 1
        elif r < weight_high:
            idx = rng.randint(len(active))
        else:
            idx = 0
        cy, cx = active[idx]
        neighbors = []
        for dy, dx in ((0, 1), (1, 0), (0, -1), (-1, 0)):
            ny, nx = cy + dy, cx + dx
            if 0 <= ny < dim_y and 0 <= nx < dim_x and not visited[ny, nx]:
                neighbors.append((ny, nx))
        if not neighbors:
            active.pop(idx)
            continue
        ny, nx = neighbors[rng.randint(len(neighbors))]
        visited[ny, nx] = True
        grid[2 * ny + 1, 2 * nx + 1] = WAY
        grid[cy + ny + 1, cx + nx + 1] = WAY  # knock down the wall between
        active.append((ny, nx))
    return grid


def _open_entries(grid: np.ndarray, random_transform: bool, rng) -> Tuple:
    """Open two border cells; default (0,1)/(H-1, W-2) like the reference."""
    H, W = grid.shape
    if not random_transform:
        grid[0, 1] = WAY
        grid[H - 1, W - 2] = WAY
        return (0, 1), (H - 1, W - 2)
    sides = rng.choice(4, size=2, replace=False)
    entries = []
    for side in sides:
        if side in (0, 1):  # top/bottom: odd column adjoins a corridor
            col = 2 * rng.randint((W - 1) // 2) + 1
            pos = (0, col) if side == 0 else (H - 1, col)
        else:
            row = 2 * rng.randint((H - 1) // 2) + 1
            pos = (row, 0) if side == 2 else (row, W - 1)
        grid[pos] = WAY
        entries.append(pos)
    return entries[0], entries[1]


def find_entries(array: np.ndarray):
    """Border openings, reference scan order (maze.py:757-778)."""
    H, W = array.shape
    entries = []
    for i in range(W):
        if array[0, i] == WAY:
            entries.append((0, i))
        if array[-1, i] == WAY:
            entries.append((H - 1, i))
    for j in range(1, H - 1):
        if array[j, 0] == WAY:
            entries.append((j, 0))
        if array[j, -1] == WAY:
            entries.append((j, W - 1))
    return entries[:2] if len(entries) >= 2 else entries


def find_path(maze: np.ndarray, random_entry: bool = False):
    """BFS the corridor graph; mark the shortest path as 1 (maze.py:780-818).

    Returns the solved maze (mutated copy semantics match the reference:
    it mutates in place and returns it) or None if unsolvable.
    """
    if random_entry:
        entries = find_entries(maze)
        if len(entries) != 2:
            return None
        start, end = entries
    else:
        start, end = (0, 1), (maze.shape[0] - 1, maze.shape[1] - 2)
    visited = np.zeros_like(maze, bool)
    visited[start] = True
    q = deque([(start, [start])])
    while q:
        node, path = q.popleft()
        if node == end:
            for pos in path:
                maze[pos] = PATH
            return maze
        for dy, dx in ((0, 1), (1, 0), (0, -1), (-1, 0)):
            nxt = (node[0] + dy, node[1] + dx)
            if (
                0 <= nxt[0] < maze.shape[0]
                and 0 <= nxt[1] < maze.shape[1]
                and maze[nxt] == WAY
                and not visited[nxt]
            ):
                visited[nxt] = True
                q.append((nxt, path + [nxt]))
    return None


def maze_gen(
    limit: int,
    dim_x: int = 7,
    dim_y: int = 7,
    random_transform: bool = True,
    weight_high: float = 99,
    weight_low: float = 97,
    seed: Optional[int] = None,
    use_native: bool = True,
) -> np.ndarray:
    """(limit, 1, 15, 15) solved mazes in {0,1,2} (maze.py:821-858).

    The C++ generator (csrc/datagen.cpp, ~150x the python path) seeded with
    `seed or 0`; with `use_native=False` the numpy generator below, seeded
    with `RandomState(seed)`.
    """
    if use_native:
        from ctdd_tpu_torch.data.native import maze_gen_native

        return maze_gen_native(
            limit, dim_x, dim_y, weight_high, weight_low, random_transform,
            seed=seed or 0,
        )
    rng = np.random.RandomState(seed)
    out = []
    while len(out) < limit:
        grid = generate_maze(dim_x, dim_y, weight_high, weight_low, rng)
        _open_entries(grid, random_transform, rng)
        solved = find_path(grid.astype(np.int32), random_transform)
        if solved is None:
            continue
        if random_transform and rng.randint(2):
            solved = np.rot90(solved).copy()
        out.append(solved)
    return np.stack(out)[:, None, :, :].astype(np.uint8)


def path_length(maze: np.ndarray):
    return (
        int(np.count_nonzero(maze == PATH)),
        int(np.count_nonzero(maze == WALL)),
        int(np.count_nonzero(maze == WAY)),
    )


def maze_acc(samples: np.ndarray, verbose: bool = False) -> float:
    """Fraction of samples that are exactly their own shortest-path solution
    (maze.py:866-898). Returns the accuracy instead of printing."""
    samples = np.asarray(samples).reshape(-1, 15, 15)
    acc = []
    for s in samples:
        clean = s.copy()
        clean[clean == PATH] = WAY
        solved = find_path(clean, True)
        acc.append(1 if solved is not None and (solved == s).all() else 0)
    result = float(np.mean(acc)) if acc else 0.0
    if verbose:
        print(f"maze_acc: {result * 100:.1f}% solvable of {len(acc)}")
    return result


@registry.datasets.register(name="Maze3SComplete")
def maze3s_complete(cfg, root=None) -> ArrayDataset:
    """Pre-generated maze set (ref maze.py:922-942)."""
    data = maze_gen(
        limit=int(cfg.data.limit),
        random_transform=bool(cfg.data.get("random_transform", True)),
        seed=int(cfg.data.get("seed", 0)),
    )
    return ArrayDataset(data)


class MazePoolDataset(ArrayDataset):
    """Maze pool that can regenerate itself with a fresh seed.

    The reference generates a fresh maze per __getitem__ (maze.py:945-966);
    training instead holds a pool of cfg.data.num_samples on the device and,
    with `data.stream_fresh` on, swaps in a freshly generated pool at epoch
    boundaries via `regenerate` (training/loop.py). The C++ generator
    (csrc/datagen.cpp) makes a 6400-maze pool in well under a second."""

    def __init__(self, n: int, random_transform: bool, seed: int):
        self._n = n
        self._random_transform = random_transform
        self._base_seed = int(seed)
        super().__init__(self._gen(mix_pool_seed(seed, 0)))

    def _gen(self, seed: int) -> np.ndarray:
        return maze_gen(
            limit=self._n, random_transform=self._random_transform, seed=seed
        )

    def regenerate(self, epoch: int) -> np.ndarray:
        """Fresh pool, deterministically keyed by (data.seed, epoch)."""
        self.data = self._gen(mix_pool_seed(self._base_seed, epoch))
        return self.data


@registry.datasets.register(name="Maze3S")
def maze3s(cfg, root=None) -> ArrayDataset:
    n = int(cfg.data.get("num_samples", cfg.data.batch_size * 50))
    return MazePoolDataset(
        n,
        random_transform=bool(cfg.data.get("random_transform", True)),
        seed=int(cfg.data.get("seed", 0)),
    )
