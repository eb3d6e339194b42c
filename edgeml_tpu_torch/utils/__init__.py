from .paths import parse_path, save_result

__all__ = ["parse_path", "save_result"]
