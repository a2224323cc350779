#!/usr/bin/env bash
# Parameter-wizard launcher (advanced_batch_process.bat:1-181 parity):
# prompts for every batch_process_images flag, then runs it on the CUDA device
# (the port's counterpart of scripts/advanced_batch_process.sh).
set -euo pipefail
cd "$(dirname "$0")/../.."

read -rp "input dir [test_images]: " input;      input=${input:-test_images}
read -rp "output dir [output/batch]: " output;   output=${output:-output/batch}
read -rp "mode (cyclegan/local_style) [local_style]: " mode
mode=${mode:-local_style}
read -rp "direction (photo2monet/monet2photo) [photo2monet]: " direction
direction=${direction:-photo2monet}
read -rp "local style mode (simple/enhanced/advanced) [enhanced]: " ls_mode
ls_mode=${ls_mode:-enhanced}
read -rp "strength (0-1) [0.8]: " strength;      strength=${strength:-0.8}
read -rp "detail (0-1) [0.7]: " detail;          detail=${detail:-0.7}
read -rp "enhance colors? (y/n) [y]: " colors;   colors=${colors:-y}
read -rp "smooth transitions? (y/n) [y]: " smooth; smooth=${smooth:-y}

args=(--input_dir "$input" --output_dir "$output" --mode "$mode"
      --direction "$direction" --local_style_mode "$ls_mode"
      --strength "$strength" --detail "$detail")
[[ "$colors" == n* ]] && args+=(--no_enhance_colors)
[[ "$smooth" == n* ]] && args+=(--no_smooth)

echo "running: python -m multi_style_transfer_gan_tpu_torch.cli.batch_process_images ${args[*]}"
python -m multi_style_transfer_gan_tpu_torch.cli.batch_process_images "${args[@]}"
