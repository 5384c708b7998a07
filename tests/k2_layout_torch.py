"""The shared-memory layout of K2's B mode, as csrc/interp_d5512.cu sizes
it (b_layout), for the tests of the planner and of the kernel library."""


def b_layout_bytes(n2f, wmax, taps, pitch, run_max=8):
    """K2's B-mode shared memory (csrc/interp_d5512.cu, b_layout): within a
    budget, the longest run of i1 (at most run_max) whose x and y tap sets
    (the family's pitch), int32 floors and 56-byte entries fit beside a
    32-byte head, two buffers of horizontal sums and one i1's window, the
    window taking the rest; two blocks an SM (114688 bytes) where that
    window holds two i1 grown by two lattice steps, else one block
    (232448); else the compact layout: one i1, one buffer (at least 88
    bytes: it holds the head and the i1 first) and a wmax x wmax window."""
    per_i1 = n2f * (2 * pitch * 8 + 2 * 4) + 56
    fixed = 2 * wmax * n2f * 8 + 32
    wmin = (wmax * (wmax + 1) + 2) & ~1

    def within(block):
        for run in range(run_max, 0, -1):
            if fixed + run * per_i1 + 8 * wmin <= block:
                wcap = ((block - fixed - run * per_i1) // 8) & ~1
                return run, wcap, fixed + run * per_i1 + 8 * wcap
        return 0, 0, None

    run, wcap, nbytes = within(114688)
    step = (wmax - taps - 1) / max(n2f - 1, 1)
    if run >= 2 and (wmax + 2 * step) * (wmax + 1) + 2 <= wcap:
        return nbytes
    run, wcap, nbytes = within(232448)
    if run >= 1:
        return nbytes
    return 8 * (wmax * wmax + 2 * n2f * pitch + max(wmax * n2f, 11)) + 8 * n2f
