#!/usr/bin/env bash
# Interactive batch-processing menu on the CUDA device (batch_process.bat:1-98
# parity; the port's counterpart of scripts/batch_process.sh).
set -euo pipefail
cd "$(dirname "$0")/../.."

PY="python -m multi_style_transfer_gan_tpu_torch.cli.batch_process_images"

echo "==============================================="
echo " batch style-transfer menu"
echo "==============================================="
echo " 1. CycleGAN photo -> monet"
echo " 2. CycleGAN monet -> photo"
echo " 3. local style (simple)   photo -> monet"
echo " 4. local style (enhanced) photo -> monet"
echo " 5. local style (advanced) photo -> monet"
echo " 6. local style (simple)   monet -> photo"
echo " 7. local style (enhanced) monet -> photo"
echo " 8. local style (advanced) monet -> photo"
echo " 9. quit"
read -rp "choice [1-9]: " choice
read -rp "input dir [test_images]: " input
input=${input:-test_images}
read -rp "output dir [output/batch]: " output
output=${output:-output/batch}

case "$choice" in
  1) $PY --input_dir "$input" --output_dir "$output" --mode cyclegan --direction photo2monet ;;
  2) $PY --input_dir "$input" --output_dir "$output" --mode cyclegan --direction monet2photo ;;
  3) $PY --input_dir "$input" --output_dir "$output" --mode local_style --local_style_mode simple --direction photo2monet ;;
  4) $PY --input_dir "$input" --output_dir "$output" --mode local_style --local_style_mode enhanced --direction photo2monet ;;
  5) $PY --input_dir "$input" --output_dir "$output" --mode local_style --local_style_mode advanced --direction photo2monet ;;
  6) $PY --input_dir "$input" --output_dir "$output" --mode local_style --local_style_mode simple --direction monet2photo ;;
  7) $PY --input_dir "$input" --output_dir "$output" --mode local_style --local_style_mode enhanced --direction monet2photo ;;
  8) $PY --input_dir "$input" --output_dir "$output" --mode local_style --local_style_mode advanced --direction monet2photo ;;
  *) echo "bye" ;;
esac
