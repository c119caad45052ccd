"""Maze scoring: the BFS solver and the solvability metric.

The scoring half of ctdd_tpu/data/maze.py, copied (numpy only): boards are
15x15 (7x7 cells and walls) with states 0 = wall, 1 = solution path,
2 = corridor. The growing-tree generator and the Maze3S datasets are ported
in a later slice.
"""

from __future__ import annotations

from collections import deque

import numpy as np

WALL, PATH, WAY = 0, 1, 2


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
