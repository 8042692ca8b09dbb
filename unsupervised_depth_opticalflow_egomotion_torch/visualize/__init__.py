from .visualizer import Visualizer, dump_mask_pack, save_disp_color_img

__all__ = ["Visualizer", "dump_mask_pack", "save_disp_color_img"]
