// Native data generators for the host-side pipelines: the port's own copy
// of the JAX package's native/datagen.cpp, code unchanged (the C++ below is
// the same text, so one seed gives the same boards from either build).
//  - maze:   growing-tree carver + BFS shortest-path solve
//            (reference lib/datasets/maze.py:18-858, python ~3ms/maze)
//  - sudoku: greedy constraint fill with restart
//            (reference lib/datasets/sudoku.py:64-105)
//
// Exposed as a C ABI for ctypes (see ctdd_tpu_torch/data/native.py, which
// builds it with the host C++ compiler at first use).

#include <cstdint>
#include <cstring>
#include <queue>
#include <random>
#include <vector>

namespace {

constexpr int WALL = 0, PATH = 1, WAY = 2;

struct Cell {
  int y, x;
};

// Growing-tree maze on a (2*dim_y+1, 2*dim_x+1) grid, values {WALL, WAY}.
// weight_low% of steps extend the newest cell; up to weight_high% pick a
// random active cell; the rest the oldest (matches ctdd_tpu/data/maze.py).
void generate_maze(std::mt19937 &rng, int dim_x, int dim_y, double weight_high,
                   double weight_low, std::vector<int8_t> &grid) {
  const int H = 2 * dim_y + 1, W = 2 * dim_x + 1;
  grid.assign(H * W, WALL);
  std::vector<uint8_t> visited(dim_y * dim_x, 0);
  std::uniform_real_distribution<double> unif(0.0, 100.0);

  Cell start{(int)(rng() % dim_y), (int)(rng() % dim_x)};
  visited[start.y * dim_x + start.x] = 1;
  grid[(2 * start.y + 1) * W + (2 * start.x + 1)] = WAY;
  std::vector<Cell> active{start};
  const int dy[4] = {0, 1, 0, -1}, dx[4] = {1, 0, -1, 0};

  while (!active.empty()) {
    double r = unif(rng);
    size_t idx;
    if (r < weight_low)
      idx = active.size() - 1;
    else if (r < weight_high)
      idx = rng() % active.size();
    else
      idx = 0;
    Cell c = active[idx];
    Cell nbrs[4];
    int n_nbrs = 0;
    for (int k = 0; k < 4; ++k) {
      int ny = c.y + dy[k], nx = c.x + dx[k];
      if (ny >= 0 && ny < dim_y && nx >= 0 && nx < dim_x &&
          !visited[ny * dim_x + nx])
        nbrs[n_nbrs++] = Cell{ny, nx};
    }
    if (n_nbrs == 0) {
      active.erase(active.begin() + idx);
      continue;
    }
    Cell n = nbrs[rng() % n_nbrs];
    visited[n.y * dim_x + n.x] = 1;
    grid[(2 * n.y + 1) * W + (2 * n.x + 1)] = WAY;
    grid[(c.y + n.y + 1) * W + (c.x + n.x + 1)] = WAY;
    active.push_back(n);
  }
}

// Open two border cells; returns entry/exit (matches _open_entries).
void open_entries(std::mt19937 &rng, std::vector<int8_t> &grid, int H, int W,
                  bool random_transform, Cell &a, Cell &b) {
  if (!random_transform) {
    a = {0, 1};
    b = {H - 1, W - 2};
    grid[a.y * W + a.x] = WAY;
    grid[b.y * W + b.x] = WAY;
    return;
  }
  int s0 = (int)(rng() % 4);
  int s1 = (int)(rng() % 3);
  if (s1 >= s0) s1 += 1;  // two distinct sides
  Cell out[2];
  int sides[2] = {s0, s1};
  for (int i = 0; i < 2; ++i) {
    int side = sides[i];
    if (side <= 1) {
      int col = 2 * (int)(rng() % ((W - 1) / 2)) + 1;
      out[i] = {side == 0 ? 0 : H - 1, col};
    } else {
      int row = 2 * (int)(rng() % ((H - 1) / 2)) + 1;
      out[i] = {row, side == 2 ? 0 : W - 1};
    }
    grid[out[i].y * W + out[i].x] = WAY;
  }
  a = out[0];
  b = out[1];
}

// BFS shortest path over WAY cells; marks it PATH. Returns success.
bool solve_maze(std::vector<int8_t> &grid, int H, int W, Cell start, Cell end) {
  std::vector<int> parent(H * W, -1);
  std::vector<uint8_t> visited(H * W, 0);
  std::queue<int> q;
  int s = start.y * W + start.x, e = end.y * W + end.x;
  visited[s] = 1;
  q.push(s);
  const int dy[4] = {0, 1, 0, -1}, dx[4] = {1, 0, -1, 0};
  while (!q.empty()) {
    int u = q.front();
    q.pop();
    if (u == e) {
      for (int v = e; v != -1; v = parent[v]) grid[v] = PATH;
      return true;
    }
    int uy = u / W, ux = u % W;
    for (int k = 0; k < 4; ++k) {
      int ny = uy + dy[k], nx = ux + dx[k];
      if (ny < 0 || ny >= H || nx < 0 || nx >= W) continue;
      int v = ny * W + nx;
      if (!visited[v] && grid[v] == WAY) {
        visited[v] = 1;
        parent[v] = u;
        q.push(v);
      }
    }
  }
  return false;
}

void rot90(const std::vector<int8_t> &in, std::vector<int8_t> &out, int H,
           int W) {
  // numpy rot90: out[W-1-x, y] = in[y, x]
  out.assign(H * W, 0);
  for (int y = 0; y < H; ++y)
    for (int x = 0; x < W; ++x) out[(W - 1 - x) * H + y] = in[y * W + x];
}

}  // namespace

extern "C" {

// out: n * (2*dim_y+1) * (2*dim_x+1) uint8 values in {0,1,2}
int maze_gen_batch(int n, int dim_x, int dim_y, double weight_high,
                   double weight_low, int random_transform, uint64_t seed,
                   uint8_t *out) {
  std::mt19937 rng((uint32_t)seed);
  const int H = 2 * dim_y + 1, W = 2 * dim_x + 1;
  std::vector<int8_t> grid, rotated;
  int produced = 0;
  int guard = 0;
  while (produced < n && guard < n * 50) {
    ++guard;
    generate_maze(rng, dim_x, dim_y, weight_high, weight_low, grid);
    Cell a, b;
    open_entries(rng, grid, H, W, random_transform != 0, a, b);
    if (!solve_maze(grid, H, W, a, b)) continue;
    const int8_t *src = grid.data();
    if (random_transform && (rng() & 1)) {
      rot90(grid, rotated, H, W);
      src = rotated.data();
    }
    for (int i = 0; i < H * W; ++i) out[(size_t)produced * H * W + i] = src[i];
    ++produced;
  }
  return produced;
}

// out: n * 81 int8 cell values in 0..8 (solved boards)
//
// Same algorithm and output distribution as the reference's
// construct_puzzle_solution (sudoku.py:64-94): raster-order greedy fill with
// a uniform choice among the remaining consistent values, full restart on a
// dead end. Hot path tuned for the stream_fresh refresh budget (measured
// ~320 attempts/board): xorshift128+ PRNG, Lemire multiply-shift reduction
// instead of modulo, k-th-set-bit select via clear-lowest + ctz. 803 ->
// 209 us/board on the dev host (a 12.8k-board pool in ~2.7s).
int sudoku_gen_batch(int n, uint64_t seed, int8_t *out) {
  // splitmix64 seeding so seed=0 works and nearby seeds decorrelate
  uint64_t sm = seed;
  auto splitmix = [&sm]() {
    uint64_t z = (sm += 0x9E3779B97F4A7C15ull);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
    return z ^ (z >> 31);
  };
  uint64_t s0 = splitmix(), s1 = splitmix();
  auto next = [&s0, &s1]() {
    uint64_t x = s0, y = s1;
    s0 = y;
    x ^= x << 23;
    s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
    return s1 + y;
  };
  for (int g = 0; g < n; ++g) {
    int8_t *board = out + (size_t)g * 81;
    while (true) {
      uint16_t rows[9], cols[9], sq[9];
      for (int i = 0; i < 9; ++i) rows[i] = cols[i] = sq[i] = 0x1FF;
      bool ok = true;
      for (int i = 0; i < 9 && ok; ++i) {
        uint16_t ri = rows[i];
        for (int j = 0; j < 9; ++j) {
          uint16_t avail = ri & cols[j] & sq[(i / 3) * 3 + j / 3];
          if (!avail) {
            ok = false;
            break;
          }
          int cnt = __builtin_popcount(avail);
          uint32_t r = (uint32_t)(next() >> 32);
          int pick = (int)(((uint64_t)r * (uint64_t)cnt) >> 32);
          uint16_t a = avail;
          while (pick--) a &= (uint16_t)(a - 1);
          int v = __builtin_ctz(a);
          uint16_t m = (uint16_t)~(1u << v);
          board[i * 9 + j] = (int8_t)v;
          ri &= m;
          cols[j] &= m;
          sq[(i / 3) * 3 + j / 3] &= m;
        }
        rows[i] = ri;
      }
      if (ok) break;
    }
  }
  return n;
}

}  // extern "C"
