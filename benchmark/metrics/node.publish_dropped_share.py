"""node.publish_dropped_share: % of the batches the vision node consumed in
the window that its bounded publish queue dropped (VisionNode's
publish_dropped over publish_count + publish_dropped). Moves
frames_per_s."""


def read(summary):
    return summary["layers"].get("publish_dropped_share")
