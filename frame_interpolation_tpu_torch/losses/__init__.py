"""Losses of the port: L1/L2/SSIM/PSNR, warped-L1, VGG-19 and Style."""

from .losses import (LossConfig, LossFn, PiecewiseConstantSchedule, WeightFn,
                     aggregate_batch_losses, compute_weighted_loss,
                     constant_schedule, create_losses, get_loss, l1_loss,
                     l1_warped_loss, l2_loss, make_style_loss,
                     make_vgg_loss, psnr_loss, ssim_loss, test_losses,
                     training_losses)

__all__ = [
    'LossConfig', 'LossFn', 'PiecewiseConstantSchedule', 'WeightFn',
    'aggregate_batch_losses', 'compute_weighted_loss', 'constant_schedule',
    'create_losses', 'get_loss', 'l1_loss', 'l1_warped_loss', 'l2_loss',
    'make_style_loss', 'make_vgg_loss', 'psnr_loss', 'ssim_loss',
    'test_losses', 'training_losses',
]
