// The route, grid and tile of a library's latest kernel launch.
//
// Each launch site notes what it launched, on the host, next to its <<<>>>
// (a handful of int stores a launch).  The library's <name>_last_launch
// export copies the note out; the Python side reads it only while a
// sim.replay recording is active, to record the geometry the card really
// ran.  One note per library (an inline variable of the shared object), so
// it describes the latest launch of that library from any host thread.
#pragma once

#include <cuda_runtime.h>

namespace repro {

struct LaunchRecord {
  int route;        // the library's route code (0 = its SIMT route)
  int gx, gy, gz;   // the grid launched
  int rows, cols;   // the tile: query rows (gemm: M rows) x keys (gemm: N)
};

inline LaunchRecord last_launch_record{};

inline void note_launch(int route, dim3 grid, int rows, int cols) {
  last_launch_record = LaunchRecord{route, (int)grid.x, (int)grid.y,
                                    (int)grid.z, rows, cols};
}

// r[0..5] = route, grid x, y, z, tile rows, tile columns.
inline int read_launch(int* r) {
  const LaunchRecord& n = last_launch_record;
  r[0] = n.route;
  r[1] = n.gx;
  r[2] = n.gy;
  r[3] = n.gz;
  r[4] = n.rows;
  r[5] = n.cols;
  return 0;
}

}  // namespace repro
