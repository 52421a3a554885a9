"""The benchmark's roofline count: the least time an H100 needs for a
kernel call, counted from the mesh and the call's steps, independent of
how the program lays its arrays out.

Per call of k steps over a brick of E elements and N nodes, in a type
of w bytes:

    bytes = w (N (3 + 3 + 3 + 1 + out) + 2 E),  out = 3 if k = 1 else 6

each read or written once per call: in, the displacement u and the
previous displacement u- (3 a node each), the damped mass (3) and the
inverse mass (1) a node, the two Lame coefficients an element; out, the
new displacement u+ (3 a node).  A call of one step writes u+ alone, as
the next step's u- is this step's u, whose buffer is already there; a
call of k >= 2 steps ends on two new levels, u_k and u_k-1, and writes
both;

    flop  = k (E F_ELEMENT + N F_NODE)

with F_ELEMENT = 330, the element force in the spectral form (an 8-point
Hadamard transform in and out around a multiply-add per nonzero of the
two sparse stiffness factors, 48 coefficient products and 24 scatter
adds), and F_NODE = 15, the update u+ = u + (f + m (u - u-)) / M of
three components.  The least time is max(bytes / 3.35 TB/s, flop /
peak), the peak of the H100 SXM data sheet at 700 W without the tensor
cores: 67 TFLOP/s in float32, 34 in float64.  So a launch of 1000 steps
is bound by its operations, and a launch of one step by its bytes.

On c cards that split the bricks between them, each card moves and
computes a c-th of the bytes and operations at its own peaks, so the
least time of a step is the one card's over c.

The bricks are the runs of element rows of one edge in the reference
mesh (``reference.fem.element_rows``).
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {"float32": 67e12, "float64": 34e12}
WORD = {"float32": 4, "float64": 8}
F_ELEMENT = 330
F_NODE = 15


def bricks(rows, extents):
    """[(elements, nodes)] of the runs of rows with one edge."""
    out = []
    i = 0
    while i < len(rows):
        j = i
        while j + 1 < len(rows) and rows[j + 1][1] == rows[i][1]:
            j += 1
        e = rows[i][1]
        nx, ny = round(extents[0] / e), round(extents[1] / e)
        nz = j - i + 1
        out.append((nx * ny * nz, (nx + 1) * (ny + 1) * (nz + 1)))
        i = j + 1
    return out


def call_bytes(elements, nodes, steps, precision):
    out = 3 if steps == 1 else 6
    return WORD[precision] * (nodes * (10 + out) + 2 * elements)


def call_flop(elements, nodes, steps):
    return steps * (elements * F_ELEMENT + nodes * F_NODE)


def least_seconds(elements, nodes, steps, precision):
    """The least time of one call of ``steps`` steps over one brick."""
    return max(call_bytes(elements, nodes, steps, precision)
               / PEAK_BYTES_PER_S,
               call_flop(elements, nodes, steps)
               / PEAK_FLOP_PER_S[precision])


def least_step_seconds(brick_sizes, steps_per_call, precision, chips=1):
    """The least time of one step of every brick on ``chips`` cards
    that share its bytes and operations, where each call runs
    ``steps_per_call`` steps."""
    return sum(least_seconds(e, n, steps_per_call, precision)
               for e, n in brick_sizes) / steps_per_call / chips


def floor_step_seconds(brick_sizes, precision, chips=1):
    """The least time of one step of every brick on any route on
    ``chips`` cards: its operations alone at their summed peak, as a
    call of ever more steps approaches it."""
    return sum(call_flop(e, n, 1) for e, n in brick_sizes) \
        / (PEAK_FLOP_PER_S[precision] * chips)
