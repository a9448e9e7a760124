"""RMS of the translation error of the estimated relative pose against the
ground truth (mm), over consecutive pairs of keyframes published in the
window: the first lap's worth of pairs of a periodic course (every point of
the course once, however far a faster port drives in the window), else
every pair. The ground truth is the course's pose at each keyframe's end
time; the relative pose is expressed in the first keyframe's body frame."""
import numpy as np


def read(run):
    return rpe(run, run.rec.published)


def rpe(run, pub):
    """The RMS for the poses ``pub`` ({keyframe: (rot, trans, ...)})."""
    ks = list(run.window_kfs)
    lap = run.rec.lap
    if lap.periodic:
        ks = ks[:lap.S + 1]
    if len(ks) < 2:
        return None
    errs = []
    for a, b in zip(ks, ks[1:]):
        Ra, ta = pub[a][0], pub[a][1]
        tb = pub[b][1]
        Ga, pa = lap.gt_pose(run.timestamps[a])
        _, pb = lap.gt_pose(run.timestamps[b])
        errs.append(Ra.T @ (tb - ta) - Ga.T @ (pb - pa))
    return 1e3 * float(np.sqrt(np.mean(np.sum(np.square(errs), axis=1))))
