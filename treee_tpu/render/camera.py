"""Camera model: perspective projection, orbital/first-person controllers, rays.

Capability parity with the reference camera stack (treee/src/camera.rs,
render/src/camera_3d.rs): 45 deg vertical FOV, near 0.1 / far 10000
(camera.rs:7,24-25), an orbital controller that orbits a pivot ``offset`` in
front of the camera and a first-person controller (camera.rs:134-217), and
pixel->ray generation for picking (camera.rs:119-127).

Everything is a pure function over a 4x4 camera-to-world transform; the "GPU
uniform" of the reference (view + projection matrices, camera_3d.rs:59-63) is
just two jnp matrices consumed by the splat rasterizer.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from ..utils import struct

ROTATE_SPEED = 0.002      # camera.rs:3 BASE_ROTATE_SPEED
VERTICAL_SPEED = 0.02     # camera.rs:4


class Camera(struct.PyTreeNode):
    """Camera state: camera-to-world transform + intrinsics."""

    transform: jax.Array                       # f32[4,4] camera-to-world
    offset: jax.Array                          # orbital pivot distance
    fov_y: float = struct.field(pytree_node=False, default=45.0 * math.tau / 360.0)
    near: float = struct.field(pytree_node=False, default=0.1)
    far: float = struct.field(pytree_node=False, default=10_000.0)

    @classmethod
    def orbital(cls, distance: float = 100.0, **kw) -> "Camera":
        """Default view: camera backed off ``distance`` along +z (camera.rs:27-28)."""
        t = jnp.eye(4).at[2, 3].set(distance)
        return cls(transform=t, offset=jnp.float32(distance), **kw)

    # ---- matrices --------------------------------------------------------------

    def view_matrix(self) -> jax.Array:
        """World-to-camera (inverse of the rigid transform)."""
        r = self.transform[:3, :3]
        t = self.transform[:3, 3]
        inv = jnp.eye(4)
        inv = inv.at[:3, :3].set(r.T)
        inv = inv.at[:3, 3].set(-r.T @ t)
        return inv

    def projection_matrix(self, aspect: float) -> jax.Array:
        """Right-handed perspective, NDC z in [0,1] (wgpu convention)."""
        f = 1.0 / math.tan(self.fov_y / 2.0)
        n, fr = self.near, self.far
        return jnp.array(
            [
                [f / aspect, 0.0, 0.0, 0.0],
                [0.0, f, 0.0, 0.0],
                [0.0, 0.0, fr / (n - fr), n * fr / (n - fr)],
                [0.0, 0.0, -1.0, 0.0],
            ],
            jnp.float32,
        )

    @property
    def position(self) -> jax.Array:
        return self.transform[:3, 3]

    # ---- controllers (pure updates) --------------------------------------------

    def rotate_orbital(self, delta_x, delta_y) -> "Camera":
        """Orbit around the pivot ``offset`` ahead of the camera (camera.rs:183-195)."""
        pivot = self.position + self.transform[:3, :3] @ jnp.array([0.0, 0.0, -1.0]) * self.offset
        yaw = -delta_x * ROTATE_SPEED
        pitch = -delta_y * ROTATE_SPEED
        t = self.transform
        # rotate around world y through the pivot
        cy, sy = jnp.cos(yaw), jnp.sin(yaw)
        rot_y = jnp.array([[cy, 0, sy, 0], [0, 1, 0, 0], [-sy, 0, cy, 0], [0, 0, 0, 1]], jnp.float32)
        trans = jnp.eye(4).at[:3, 3].set(pivot)
        untrans = jnp.eye(4).at[:3, 3].set(-pivot)
        t = trans @ rot_y @ untrans @ t
        # pitch around the camera's local x at the pivot
        cp, sp = jnp.cos(pitch), jnp.sin(pitch)
        rot_x = jnp.array([[1, 0, 0, 0], [0, cp, -sp, 0], [0, sp, cp, 0], [0, 0, 0, 1]], jnp.float32)
        off = jnp.eye(4).at[2, 3].set(-self.offset)
        unoff = jnp.eye(4).at[2, 3].set(self.offset)
        t = t @ off @ rot_x @ unoff
        return self.replace(transform=t)

    def scroll_orbital(self, value) -> "Camera":
        """Exponential zoom toward the pivot (camera.rs:207-214)."""
        new_offset = jnp.maximum(self.offset * (1.0 + value / 10.0), 0.01)
        shift = jnp.eye(4).at[2, 3].set(new_offset - self.offset)
        return self.replace(transform=self.transform @ shift, offset=new_offset)

    def move_orbital(self, direction_x, direction_y) -> "Camera":
        """WASD pan scaled by the pivot distance (camera.rs:159-164)."""
        right = self.transform[:3, :3] @ jnp.array([1.0, 0.0, 0.0])
        fwd = jnp.cross(right, jnp.array([0.0, 1.0, 0.0]))
        v = (right * direction_x + fwd * direction_y) * self.offset
        t = self.transform.at[:3, 3].add(v)
        return self.replace(transform=t)

    def move_vertical(self, amount) -> "Camera":
        t = self.transform.at[:3, 3].add(
            jnp.array([0.0, 1.0, 0.0]) * amount * self.offset * VERTICAL_SPEED
        )
        return self.replace(transform=t)

    # ---- first-person controller (camera.rs:147-216, Controller::FirstPerson;
    # ``offset`` doubles as the move sensitivity, Controller::distance) -------

    def move_first_person(self, direction_x, direction_y) -> "Camera":
        """Translate in the camera's local xz plane (camera.rs:152-155)."""
        local = jnp.eye(4).at[:3, 3].set(
            jnp.array([1.0, 0.0, 0.0]) * direction_x * self.offset
            + jnp.array([0.0, 0.0, 1.0]) * direction_y * self.offset
        )
        return self.replace(transform=self.transform @ local)

    def rotate_first_person(self, delta_x, delta_y) -> "Camera":
        """Yaw around world y through the camera position, pitch around the
        local x axis (camera.rs:170-182)."""
        yaw = -delta_x * ROTATE_SPEED
        pitch = -delta_y * ROTATE_SPEED
        p = self.position
        cy, sy = jnp.cos(yaw), jnp.sin(yaw)
        rot_y = jnp.array(
            [[cy, 0, sy, 0], [0, 1, 0, 0], [-sy, 0, cy, 0], [0, 0, 0, 1]],
            jnp.float32,
        )
        cp, sp = jnp.cos(pitch), jnp.sin(pitch)
        rot_x = jnp.array(
            [[1, 0, 0, 0], [0, cp, -sp, 0], [0, sp, cp, 0], [0, 0, 0, 1]],
            jnp.float32,
        )
        trans = jnp.eye(4).at[:3, 3].set(p)
        untrans = jnp.eye(4).at[:3, 3].set(-p)
        return self.replace(
            transform=trans @ rot_y @ untrans @ self.transform @ rot_x
        )

    def scroll_first_person(self, value) -> "Camera":
        """Scroll adjusts the move sensitivity, not the pose (camera.rs:202-206)."""
        return self.replace(
            offset=jnp.maximum(self.offset * (1.0 + value / 10.0), 0.01)
        )

    # ---- frustum ----------------------------------------------------------------

    def frustum_planes(self, aspect: float) -> jax.Array:
        """World-space frustum planes f32[6,4]: a*x+b*y+c*z+d >= 0 inside.

        The reference carries equivalent frustum helpers that nothing calls
        (camera.rs:94-109, camera_3d.rs:20-51 ``inside``); here they feed LOD
        node culling (ops/octree.lod_mask frustum arg).  Planes come from the
        view-projection rows (Gribb-Hartmann), wgpu z in [0,1].
        """
        m = self.projection_matrix(aspect) @ self.view_matrix()
        planes = jnp.stack([
            m[3] + m[0],   # left
            m[3] - m[0],   # right
            m[3] + m[1],   # bottom
            m[3] - m[1],   # top
            m[2],          # near (z01 >= 0)
            m[3] - m[2],   # far
        ])
        norm = jnp.linalg.norm(planes[:, :3], axis=1, keepdims=True)
        return planes / jnp.maximum(norm, 1e-12)

    # ---- picking ----------------------------------------------------------------

    def ray_direction(self, pixel_x, pixel_y, width: int, height: int) -> jax.Array:
        """World-space ray through a pixel (camera.rs:119-127)."""
        dist = (height / 2.0) / math.tan(self.fov_y / 2.0)
        v = jnp.array(
            [pixel_x - width / 2.0, -(pixel_y - height / 2.0), -dist], jnp.float32
        )
        d = self.transform[:3, :3] @ v
        return d / jnp.linalg.norm(d)
