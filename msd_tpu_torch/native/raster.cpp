// Offscreen software rasterizer (C ABI, loaded via ctypes); a copy of
// msd_tpu/native/raster.cpp, built with the same g++ flags so both give
// the same bits on one host.
//
// Replacement for the reference's OpenGL render passes:
//  * deep_sdf/plotting.py:127-146 pyrender_helper — shaded color + depth
//    images for eval figures (pyrender/EGL is not available here);
//  * src/ShaderProgram.cpp:5-141 — the per-pixel world-position +
//    primitive-id framebuffer used by PreprocessMesh's multi-view
//    visibility pass (PreprocessMesh.cpp:443-494): the face-id output of
//    rast_render gives exactly the "which triangles are visible from this
//    camera" information the GLSL geometry shader emitted in FragColor.w.
//
// Perspective camera looking down -Z (pyrender convention), z-buffered
// half-space triangle rasterization, flat Lambert shading from a headlight
// at the camera. Single-threaded; callers parallelize over views.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>

extern "C" {

// verts [nv,3] world-space; faces [nf,3]; cam_pose [16] row-major 4x4
// camera-to-world (pyrender convention: camera looks along -Z of its own
// frame). Outputs (optional = may be null):
//   color  u8 [H,W,3]   flat-shaded Lambert, black background
//   depth  f32 [H,W]    distance along -Z_cam (0 where no geometry)
//   faceid i32 [H,W]    triangle id + 1 (0 = background) — the reference
//                       shader's primitiveID+1 channel
void rast_render(
    const float* verts, int64_t nv, const int32_t* faces, int64_t nf,
    const float* cam_pose, float yfov, int W, int H,
    uint8_t* color, float* depth, int32_t* faceid) {
  // world -> camera: R^T (x - t)
  float R[3][3], t[3];
  for (int i = 0; i < 3; i++) {
    for (int j = 0; j < 3; j++) R[i][j] = cam_pose[i * 4 + j];
    t[i] = cam_pose[i * 4 + 3];
  }
  const float f = 1.0f / std::tan(yfov * 0.5f);
  const float aspect = (float)W / (float)H;
  const float znear = 1e-3f;

  float* zbuf = new float[(size_t)W * H];
  for (int64_t i = 0; i < (int64_t)W * H; i++) zbuf[i] = std::numeric_limits<float>::max();
  if (color) std::memset(color, 0, (size_t)W * H * 3);
  if (depth) std::memset(depth, 0, (size_t)W * H * sizeof(float));
  if (faceid) std::memset(faceid, 0, (size_t)W * H * sizeof(int32_t));

  // precompute camera-space vertices
  float* vc = new float[(size_t)nv * 3];
  for (int64_t i = 0; i < nv; i++) {
    float d[3] = {verts[3 * i] - t[0], verts[3 * i + 1] - t[1], verts[3 * i + 2] - t[2]};
    for (int a = 0; a < 3; a++)
      vc[3 * i + a] = R[0][a] * d[0] + R[1][a] * d[1] + R[2][a] * d[2];
  }

  for (int64_t fi = 0; fi < nf; fi++) {
    const int32_t* tri = faces + 3 * fi;
    const float* a = vc + 3 * tri[0];
    const float* b = vc + 3 * tri[1];
    const float* c = vc + 3 * tri[2];
    // cull triangles not fully in front of the near plane (no clipping:
    // meshes here are normalized well inside the camera distance)
    if (-a[2] < znear || -b[2] < znear || -c[2] < znear) continue;

    // project to screen
    auto sx = [&](const float* v) { return (f * v[0] / (-v[2]) / aspect + 1.0f) * 0.5f * W; };
    auto sy = [&](const float* v) { return (1.0f - f * v[1] / (-v[2])) * 0.5f * H; };
    const float ax = sx(a), ay = sy(a), bx = sx(b), by = sy(b), cx = sx(c), cy = sy(c);

    const float area = (bx - ax) * (cy - ay) - (cx - ax) * (by - ay);
    if (std::fabs(area) < 1e-12f) continue;
    const float inv_area = 1.0f / area;

    int x0 = (int)std::floor(std::fmin(ax, std::fmin(bx, cx)));
    int x1 = (int)std::ceil(std::fmax(ax, std::fmax(bx, cx)));
    int y0 = (int)std::floor(std::fmin(ay, std::fmin(by, cy)));
    int y1 = (int)std::ceil(std::fmax(ay, std::fmax(by, cy)));
    if (x0 < 0) x0 = 0;
    if (y0 < 0) y0 = 0;
    if (x1 > W - 1) x1 = W - 1;
    if (y1 > H - 1) y1 = H - 1;
    if (x0 > x1 || y0 > y1) continue;

    // flat shading: camera-space face normal vs headlight (0,0,1)
    float e1[3] = {b[0] - a[0], b[1] - a[1], b[2] - a[2]};
    float e2[3] = {c[0] - a[0], c[1] - a[1], c[2] - a[2]};
    float nx = e1[1] * e2[2] - e1[2] * e2[1];
    float ny = e1[2] * e2[0] - e1[0] * e2[2];
    float nz = e1[0] * e2[1] - e1[1] * e2[0];
    float nl = std::sqrt(nx * nx + ny * ny + nz * nz);
    float lambert = nl > 0 ? std::fabs(nz) / nl : 0.0f;  // double-sided
    float shade = 0.25f + 0.75f * lambert;
    uint8_t col[3] = {(uint8_t)(175 * shade), (uint8_t)(189 * shade), (uint8_t)(217 * shade)};

    // perspective-correct depth: 1/z is affine in screen space, z is not
    // (all three z's are > znear after the cull above)
    const float iza = 1.0f / -a[2], izb = 1.0f / -b[2], izc = 1.0f / -c[2];
    for (int y = y0; y <= y1; y++) {
      const float py = y + 0.5f;
      for (int x = x0; x <= x1; x++) {
        const float px = x + 0.5f;
        float w0 = ((bx - px) * (cy - py) - (cx - px) * (by - py)) * inv_area;
        float w1 = ((cx - px) * (ay - py) - (ax - px) * (cy - py)) * inv_area;
        float w2 = 1.0f - w0 - w1;
        if (w0 < 0 || w1 < 0 || w2 < 0) continue;
        float z = 1.0f / (w0 * iza + w1 * izb + w2 * izc);
        int64_t pix = (int64_t)y * W + x;
        if (z < zbuf[pix]) {
          zbuf[pix] = z;
          if (depth) depth[pix] = z;
          if (faceid) faceid[pix] = (int32_t)(fi + 1);
          if (color) {
            color[3 * pix] = col[0];
            color[3 * pix + 1] = col[1];
            color[3 * pix + 2] = col[2];
          }
        }
      }
    }
  }
  delete[] vc;
  delete[] zbuf;
}

// Multi-view visibility: render the mesh from `num_views` cameras
// (cam_poses [num_views,16]) at WxH using only the face-id buffer and OR
// the observed ids into visible [nf] (u8 0/1). Also counts, per view, the
// pixels whose triangle faced away from the camera (camera-space normal
// pointing away) — the reference's wrong-normal mesh-quality diagnostic
// (Utils.cpp:28-75 ValidPointsFromIm wrong-normal counting).
void rast_visibility(
    const float* verts, int64_t nv, const int32_t* faces, int64_t nf,
    const float* cam_poses, int num_views, float yfov, int W, int H,
    uint8_t* visible, int64_t* covered_pix, int64_t* wrong_normal_pix) {
  int32_t* fid = new int32_t[(size_t)W * H];
  std::memset(visible, 0, (size_t)nf);
  int64_t covered = 0, wrong = 0;
  for (int v = 0; v < num_views; v++) {
    const float* pose = cam_poses + 16 * v;
    rast_render(verts, nv, faces, nf, pose, yfov, W, H, nullptr, nullptr, fid);
    // camera position and forward (-Z of camera frame, world space)
    float cpos[3] = {pose[3], pose[7], pose[11]};
    for (int64_t p = 0; p < (int64_t)W * H; p++) {
      int32_t id = fid[p];
      if (id == 0) continue;
      covered++;
      int64_t fi = id - 1;
      visible[fi] = 1;
      // outward test: does the face normal point toward the camera?
      const int32_t* tri = faces + 3 * fi;
      const float* a = verts + 3 * tri[0];
      const float* b = verts + 3 * tri[1];
      const float* c = verts + 3 * tri[2];
      float e1[3] = {b[0] - a[0], b[1] - a[1], b[2] - a[2]};
      float e2[3] = {c[0] - a[0], c[1] - a[1], c[2] - a[2]};
      float n[3] = {e1[1] * e2[2] - e1[2] * e2[1],
                    e1[2] * e2[0] - e1[0] * e2[2],
                    e1[0] * e2[1] - e1[1] * e2[0]};
      float toc[3] = {cpos[0] - a[0], cpos[1] - a[1], cpos[2] - a[2]};
      if (n[0] * toc[0] + n[1] * toc[1] + n[2] * toc[2] < 0) wrong++;
    }
  }
  if (covered_pix) *covered_pix = covered;
  if (wrong_normal_pix) *wrong_normal_pix = wrong;
  delete[] fid;
}

}  // extern "C"
