"""Detection ops: exact class-aware NMS and its fused suppressor kernel."""
