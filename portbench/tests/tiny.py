"""Tiny shapes of the benchmark's cells, for runs on the CPU."""

TINY = {
    "loftr_ds_r5.scene16_832": dict(n_views=3, width=96, height=72,
                                    frame=96, pairs_per_call=3,
                                    batch_size=2, sample=3),
    "loftr_ds_r5.eth3d_1600": dict(n_views=3, width=96, height=64,
                                   frame=96, pairs_per_call=2,
                                   batch_size=2, sample=2),
    "mvrefiner_r4.tracks_832": dict(n_views=4, width=96, height=72,
                                    n_tracks=40, chunk_tracks=16,
                                    sample=3),
}
